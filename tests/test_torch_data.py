"""The port's copy of the Synapse data path against the JAX package's.

On a few synthetic ``.npz`` slices (96×80, zoomed to 64): ``SynapseDataset.get_train``
and ``Loader`` batches are bit-equal to ``cenet_tpu.data``'s for the same seed,
epoch and index, through both the OpenCV and the numpy resampling paths (the
card's machine may lack OpenCV), and ``device_put_fn`` turns a batch into NCHW
tensors on the device asked for.
"""

import os

import numpy as np
import pytest
import torch

from cenet_tpu.data import augment as jaugment
from cenet_tpu.data.loader import Loader as JLoader, seeded_epoch_order as jorder
from cenet_tpu.data.synapse import SynapseDataset as JSynapse
from cenet_tpu_torch.data import augment as taugment
from cenet_tpu_torch.data.loader import Loader, device_put_fn, seeded_epoch_order
from cenet_tpu_torch.data.synapse import SynapseDataset

N_SLICES = 6


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("synapse")
    rng = np.random.default_rng(0)
    names = []
    for i in range(N_SLICES):
        image = rng.random((96, 80)).astype(np.float32)
        label = np.zeros((96, 80), np.uint8)
        for c in range(1, 9):
            y, x = rng.integers(0, 80), rng.integers(0, 64)
            label[y:y + 12, x:x + 14] = c
        name = f"case0001_slice{i:03d}"
        np.savez(os.path.join(root, name + ".npz"), image=image, label=label)
        names.append(name)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return str(root)


@pytest.fixture(params=["cv2", "numpy"])
def resampler(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jaugment, "cv2", None)
        monkeypatch.setattr(taugment, "cv2", None)
    elif taugment.cv2 is None:
        pytest.skip("OpenCV is not installed")
    return request.param


def test_get_train_is_bit_equal_to_jax(split_dir, resampler):
    jds = JSynapse(split_dir, split_dir, "train", img_size=64)
    tds = SynapseDataset(split_dir, split_dir, "train", img_size=64)
    assert len(tds) == len(jds) == N_SLICES
    for idx in range(N_SLICES):
        for seed in range(4):  # several draws per slice: most of the ten augmenters run
            want = jds.get_train(idx, np.random.default_rng(seed))
            got = tds.get_train(idx, np.random.default_rng(seed))
            assert got["case_name"] == want["case_name"]
            for key in ("image", "label"):
                assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} {idx} {seed}")


def test_loader_batches_are_bit_equal_to_jax(split_dir, resampler):
    tds = SynapseDataset(split_dir, split_dir, "train", img_size=64)
    jds = JSynapse(split_dir, split_dir, "train", img_size=64)
    np.testing.assert_array_equal(seeded_epoch_order(N_SLICES, 3, 1), jorder(N_SLICES, 3, 1))
    tl = Loader(len(tds), tds.get_train, batch_size=2, seed=3, num_threads=2, prefetch=1)
    jl = JLoader(len(jds), jds.get_train, batch_size=2, seed=3, num_threads=2, prefetch=1)
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == N_SLICES // 2
        for g, w in zip(got, want):
            assert g["case_name"] == w["case_name"]
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])


def test_device_put_fn_gives_nchw_tensors(split_dir):
    tds = SynapseDataset(split_dir, split_dir, "train", img_size=64)
    loader = Loader(len(tds), tds.get_train, batch_size=3, seed=0, num_threads=1, put_fn=device_put_fn("cpu"))
    batch = next(iter(loader.epoch(0)))
    assert batch["image"].shape == (3, 1, 64, 64) and batch["image"].dtype == torch.float32
    assert batch["label"].shape == (3, 64, 64) and batch["label"].dtype == torch.int32
    first = int(seeded_epoch_order(len(tds), 0, 0)[0])
    raw = tds.get_train(first, np.random.default_rng(np.random.SeedSequence([0, 0, first])))
    np.testing.assert_array_equal(batch["image"][0, 0].numpy(), raw["image"][..., 0])
