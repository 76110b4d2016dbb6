"""The port's ACDC and skin data paths, noise transforms, misc helpers and skin
metrics against the JAX package's, to the bit.

* ``random_generator`` (the ACDC ``RandomGenerator``) and ``ACDCDataset``
  (train slices through it, valid slices, test volumes) on seeded synthetic
  ``.npz`` files, for the same ``np.random.default_rng(seed)`` draws;
* ``SkinAug`` on uint8 HWC images and masks, through OpenCV and through the
  scipy path (OpenCV set to None in both packages);
* ``prepare_skin_cache`` and ``SkinDataset`` over caches that each package
  builds from the same few synthetic JPEG/PNG (HAM10000) and BMP (PH2) files
  with PIL, on both resize paths; a ``SkinDataset`` over an existing cache
  imports no PIL;
* ``AddNoise`` (every noise type), ``AvgMeter``, ``powerset``,
  ``one_hot_encoder`` and ``histogram_equalization_rgb``;
* ``skin_val`` and ``skin_test`` on the same probabilities (the port's as
  (B, K, H, W) tensors, the JAX package's as (B, H, W, K) arrays), with their
  save hooks, and ``skin_overlay`` writing the JAX package's PNG from an HWC
  and from a CHW image.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cenet_tpu_torch.tools.synthetic import skin_pair, write_acdc, write_skin_cache, write_skin_raw
from cenet_tpu.core import misc as jmisc
from cenet_tpu.data import augment as jaugment
from cenet_tpu.data import skin as jskin
from cenet_tpu.data.acdc import ACDCDataset as JACDCDataset
from cenet_tpu.data.tta import AddNoise as JAddNoise
from cenet_tpu.evaluate import skin as jeskin
from cenet_tpu.evaluate import visualize as jvis
from cenet_tpu_torch.core import misc as tmisc
from cenet_tpu_torch.data import augment as taugment
from cenet_tpu_torch.data import skin as tskin
from cenet_tpu_torch.data.acdc import ACDCDataset
from cenet_tpu_torch.data.tta import AddNoise
from cenet_tpu_torch.evaluate import skin as teskin
from cenet_tpu_torch.evaluate import visualize as tvis

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(12)  # enough draws that every branch of each pipeline runs


def assert_same(got, want, where=""):
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.fixture(params=["cv2", "numpy"])
def resampler(request, monkeypatch):
    """OpenCV where it is installed, or the scipy/PIL paths in both packages."""
    if request.param == "numpy":
        monkeypatch.setattr(jaugment, "cv2", None)
        monkeypatch.setattr(taugment, "cv2", None)
        monkeypatch.setattr(jskin, "cv2", None)
        monkeypatch.setitem(sys.modules, "cv2", None)  # the port's skin module imports it at the call
    elif taugment.cv2 is None:
        pytest.skip("OpenCV is not installed")
    return request.param


def test_random_generator_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    for shape, out in (((40, 36), 32), ((32, 32), 32)):  # zoomed, and at its size already
        image = rng.random(shape).astype(np.float32)
        label = rng.integers(0, 4, shape).astype(np.uint8)
        for seed in SEEDS:
            want = jaugment.random_generator(image.copy(), label.copy(), out, np.random.default_rng(seed))
            got = taugment.random_generator(image.copy(), label.copy(), out, np.random.default_rng(seed))
            for g, w in zip(got, want):
                assert_same(g, w, f"{shape} seed {seed}")


@pytest.fixture(scope="module")
def acdc_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc"))
    write_acdc(root, n_train=4, n_valid=2, n_test=2, h=40, w=36)
    return root


def test_acdc_dataset_is_bit_equal_to_jax(acdc_dir):
    for split in ("train", "valid", "test"):
        preload = split != "test"
        want = JACDCDataset(acdc_dir, acdc_dir, split, img_size=32, preload=preload)
        got = ACDCDataset(acdc_dir, acdc_dir, split, img_size=32, preload=preload)
        assert len(got) == len(want) > 0 and got.sample_list == want.sample_list
        for idx in range(len(want)):
            assert_same(got.get_eval(idx), want.get_eval(idx), f"{split} {idx}")
            if split == "train":
                for seed in SEEDS:
                    assert_same(got.get_train(idx, np.random.default_rng(seed)),
                                want.get_train(idx, np.random.default_rng(seed)), f"train {idx} seed {seed}")
        for g, w in zip(got.volumes(), want.volumes()):
            assert_same(g, w, split)


def test_skin_aug_is_bit_equal_to_jax(resampler):
    rng = np.random.default_rng(1)
    for i in range(3):
        image, mask = skin_pair(rng, 36)
        for seed in SEEDS:
            want = jaugment.SkinAug()(image.copy(), mask.copy(), np.random.default_rng(seed))
            got = taugment.SkinAug()(image.copy(), mask.copy(), np.random.default_rng(seed))
            for g, w in zip(got, want):
                assert_same(g, w, f"{resampler} image {i} seed {seed}")


@pytest.mark.parametrize("dataset", ["ham10000", "ph2"])
def test_skin_cache_and_dataset_are_bit_equal_to_jax(dataset, resampler, tmp_path):
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(tmp_path / side)
        write_skin_raw(roots[side], dataset, n=5)
    want_paths = jskin.prepare_skin_cache(dataset, roots["jax"], img_size=32)
    got_paths = tskin.prepare_skin_cache(dataset, roots["port"], img_size=32)
    for g, w in zip(got_paths, want_paths):
        assert os.path.basename(g) == os.path.basename(w)
        assert_same(np.load(g), np.load(w), os.path.basename(g))
    assert np.load(got_paths[1]).max() == 1  # the masks hold lesions
    want = jskin.SkinDataset(dataset, roots["jax"], "train", img_size=32)
    got = tskin.SkinDataset(dataset, roots["port"], "train", img_size=32)
    assert len(got) == len(want) == 5
    for idx in range(5):
        assert_same(got.get_eval(idx), want.get_eval(idx), f"eval {idx}")
        for seed in range(4):
            assert_same(got.get_train(idx, np.random.default_rng(seed)),
                        want.get_train(idx, np.random.default_rng(seed)), f"train {idx} seed {seed}")
    assert_same(tskin._minmax(np.full((3, 3), 7, np.uint8)), jskin._minmax(np.full((3, 3), 7, np.uint8)))


def test_skin_dataset_over_a_cache_imports_no_pil_and_splits_as_jax(tmp_path):
    write_skin_cache(str(tmp_path), 32, n=4, rows=104)
    code = ("import sys; from cenet_tpu_torch.data.skin import SkinDataset; "
            f"ds = SkinDataset('ph2', {str(tmp_path)!r}, 'test', 32); "
            "print(len(ds), sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'jax', 'cenet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split(maxsplit=1) == ["4", "[]\n"]
    assert tskin.SPLITS == jskin.SPLITS
    for split in ("train", "val", "test"):
        got = tskin.SkinDataset("ph2", str(tmp_path), split, 32)
        want = jskin.SkinDataset("ph2", str(tmp_path), split, 32)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(FileNotFoundError, match="no images found"):
        tskin.prepare_skin_cache("ph2", str(tmp_path / "empty"), 32)


@pytest.mark.parametrize("noise, params", [("salt_pepper", {"salt_prob": 0.1, "pepper_prob": 0.2}),
                                           ("gaussian", {"mean": 0.1, "std": 0.3}), ("poisson", {}),
                                           ("speckle", {"std": 0.2}), ("none", {})])
def test_add_noise_is_bit_equal_to_jax(noise, params):
    x = np.random.default_rng(2).random((3, 16, 12)).astype(np.float32)
    got_t = AddNoise(noise, rng=np.random.default_rng(5), **params)
    want_t = JAddNoise(noise, rng=np.random.default_rng(5), **params)
    for _ in range(2):  # the generator's state carries from one call to the next
        assert_same(got_t(x), want_t(x), noise)
    got_t.set_params(std=0.05)
    want_t.set_params(std=0.05)
    assert_same(got_t(x), want_t(x), f"{noise} after set_params")
    assert_same(AddNoise("gaussian")(x), JAddNoise("gaussian")(x), "default generator")


def test_misc_helpers_equal_jax():
    got, want = tmisc.AvgMeter(num=3), jmisc.AvgMeter(num=3)
    assert got.show() == want.show() == 0.0
    for v, n in ((0.5, 1), (1.25, 2), (0.1, 1), (3.0, 4), (0.7, 1)):
        got.update(v, n)
        want.update(v, n)
        assert (got.val, got.avg, got.sum, got.count, got.show()) == (want.val, want.avg, want.sum, want.count,
                                                                      want.show())
    got.reset()
    assert got.losses == [] and got.count == 0
    assert tmisc.powerset("abc") == jmisc.powerset("abc") and len(tmisc.powerset(range(4))) == 15
    vol = np.random.default_rng(3).integers(0, 5, (4, 6, 7))
    assert_same(tmisc.one_hot_encoder(vol, [1, 3, 4]), jmisc.one_hot_encoder(vol, [1, 3, 4]))
    img, _ = skin_pair(np.random.default_rng(4), 24)
    img[..., 2] = 9  # one flat channel
    assert_same(tmisc.histogram_equalization_rgb(img), jmisc.histogram_equalization_rgb(img))


def test_skin_val_and_test_equal_jax_on_the_same_probabilities():
    rng = np.random.default_rng(6)
    batches, jbatches = [], []
    for b in (4, 4, 3):
        logits = rng.normal(size=(b, 2, 20, 18)).astype(np.float32)
        probs = torch.softmax(torch.from_numpy(logits), dim=1)
        label = (rng.random((b, 20, 18)) < 0.4).astype(np.int32)
        batches.append({"image": probs, "label": label})
        jbatches.append({"image": probs.numpy().transpose(0, 2, 3, 1), "label": label})
    assert teskin.skin_val(lambda x: x, batches) == jeskin.skin_val(lambda x: x, jbatches)
    got_preds, want_preds = [], []
    got = teskin.skin_test(lambda x: x, batches, save_hook=lambda b, p: got_preds.append(p))
    want = jeskin.skin_test(lambda x: x, jbatches, save_hook=lambda b, p: want_preds.append(p))
    assert got == want and all(0.0 <= v <= 1.0 for v in got)
    assert len(got_preds) == 3
    for g, w in zip(got_preds, want_preds):
        assert_same(g, w)
    for p, gt in ((np.zeros((2, 3)), np.zeros((2, 3))), (np.ones((2, 3)), np.zeros((2, 3)))):
        assert teskin._batch_dice(p, gt) == jeskin._batch_dice(p, gt)


def test_skin_overlay_writes_the_jax_png(tmp_path):
    import matplotlib.image as mpimg

    image, mask = skin_pair(np.random.default_rng(7), 48)
    pred = np.roll(mask, 3, axis=0)
    hwc = image.astype(np.float32) / 255.0
    jvis.skin_overlay(hwc, mask, pred, str(tmp_path / "j" / "a.png"))
    tvis.skin_overlay(hwc, mask, pred, str(tmp_path / "t" / "a.png"))
    tvis.skin_overlay(np.ascontiguousarray(hwc.transpose(2, 0, 1)), mask, pred, str(tmp_path / "t" / "chw.png"))
    want = mpimg.imread(str(tmp_path / "j" / "a.png"))
    assert want.shape[0] > 0
    for name in ("a.png", "chw.png"):
        np.testing.assert_array_equal(mpimg.imread(str(tmp_path / "t" / name)), want)
