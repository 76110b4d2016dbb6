"""The port's ``cli eval`` path on the CPU: checkpoints, the CLI, NIfTI and the native EDT.

``python -m cenet_tpu_torch.cli.main eval`` runs here with ``--device cpu`` on
the slim model (CENet with pvt_v2_b0 at 64 px: the Synapse preset with its
encoder and image size cut) over two synthetic ``.npy.h5`` cases in a temporary
directory:

* a ``.pth`` of the port's seeded weights: the printed JSON equals
  ``run_inference`` called directly on the same weights (exactly), and
  ``--is_savenii`` files read back equal to the prediction, image and label;
* the same weights as a JAX-format ``.npz``: the JAX package's converter
  (``convert_state_dict``, on the variable tree of a JAX ``init`` taken by
  ``jax.eval_shape``, so no JAX compile) and ``_save_npz`` write it; loaded by
  the CLI's loader (``load_checkpoint``), it gives back the ``.pth``'s
  state_dict bit for bit, so the CLI prints the ``.pth``'s JSON line for it
  (one CLI run serves both formats);
* the ACDC and skin presets' modes run: ``train --preset acdc`` and ``eval``
  of acdc, ham10000 and ph2 on seeded data, each eval's JSON equal to its
  metrics computed directly;
* the modes and options not ported yet exit naming their ROADMAP item;
  ``train --model_stats`` logs ``model_cost``'s line;
  a directory without a checkpoint raises ``FileNotFoundError``, an Orbax tag
  directory without ``params`` (or a snapshot that holds one) ``ValueError``
  naming them; without
  ``--device`` the CLI needs the card.

The port's native EDT is held to ``scipy.ndimage.distance_transform_edt`` at
``tests/test_metrics.py``'s shapes within 1e-9, and the NIfTI copy to the JAX
package's reader and writer byte for byte.
"""

import contextlib
import dataclasses
import io
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from scipy import ndimage

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu_torch.tools.synthetic import write_acdc, write_skin_cache
from cenet_tpu.convert.torch2jax import convert_state_dict
from cenet_tpu.core.checkpoint import _save_npz
from cenet_tpu.evaluate import nifti as jnifti
from cenet_tpu.models.cenet import CENet as JCENet
from cenet_tpu_torch import native
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.core.checkpoint import load_checkpoint, state_dict_from_npz
from cenet_tpu_torch.core.stats import model_cost
from cenet_tpu_torch.data.acdc import ACDCDataset
from cenet_tpu_torch.data.skin import SkinDataset
from cenet_tpu_torch.evaluate import nifti as tnifti
from cenet_tpu_torch.evaluate.predict import make_predict_fn
from cenet_tpu_torch.evaluate.skin import skin_test
from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer, run_inference
from cenet_tpu_torch.models.cenet import build_model

IMG = 64
ENCODER = "pvt_v2_b0"


def _slim_preset(get_preset):
    def preset(name):
        cfg = get_preset(name)
        return cfg.replace(data=dataclasses.replace(cfg.data, img_size=IMG))

    return preset


@pytest.fixture
def slim(monkeypatch):
    """The Synapse preset at 64 px, as the CLI's ``make_config`` reads it."""
    monkeypatch.setattr(tconfig, "get_preset", _slim_preset(tconfig.get_preset))


def _case(rng, d=3, h=80, w=80):
    label = np.zeros((d, h, w), np.uint8)
    label[:, 20:50, 24:60] = 1 + rng.integers(0, 8)
    label[:, 50:70, 10:30] = 1 + rng.integers(0, 8)
    image = (label * 0.1 + rng.integers(-40, 40, (d, h, w)) / 100.0).astype(np.float32)
    return image, label


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two cases as ``.npy.h5``, their list, and one seeded b0's weights as ``.pth`` and ``.npz``."""
    root = tmp_path_factory.mktemp("synapse")
    rng = np.random.default_rng(0)
    names = ["case0001", "case0002"]
    cases = []
    for name in names:
        image, label = _case(rng)
        with h5py.File(root / f"{name}.npy.h5", "w") as f:
            f["image"], f["label"] = image, label
        cases.append({"image": image, "label": label, "case_name": name})
    (root / "test_vol.txt").write_text("\n".join(names) + "\n")

    cfg = tconfig.get_preset("synapse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder=ENCODER),
                      data=dataclasses.replace(cfg.data, img_size=IMG))
    model = build_model(cfg, device="cpu", seed=3)
    sd = model.state_dict()
    torch.save({"state_dict": sd}, root / "w.pth")

    m = cfg.model
    jm = JCENet(input_channels=m.input_channels, num_classes=m.num_classes, scale_factors=m.scale_factors,
                diffatt_num_heads=m.diffatt_num_heads, encoder=m.encoder, skip_mode=m.skip_mode,
                dec_up_block=m.dec_up_block, out_merge_mode=m.out_merge_mode, out_up_block=m.out_up_block,
                out_up_ks=m.out_up_ks, skip_use_command=m.skip_use_command)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x), jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 1)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables, _ = convert_state_dict({k: v.numpy() for k, v in sd.items()}, template, strict=True)
    _save_npz(str(root / "w.npz"), variables)
    return dict(root=root, cases=cases, cfg=cfg, model=model, sd=sd)


def _argv(data, ckpt, *extra):
    return ["eval", "--preset", "synapse", "--encoder", ENCODER, "--device", "cpu", "--checkpoint", str(ckpt),
            "--root_path", str(data["root"]), "--list_dir", str(data["root"]),
            "--output_dir", str(data["root"] / "out"), *extra]


@pytest.fixture(scope="module")
def pth_run(data):
    """``cli eval`` with the ``.pth``, ``--is_savenii`` and ``--save_figs``: (its result, its printed line)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "get_preset", _slim_preset(tconfig.get_preset))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = cli.main(_argv(data, data["root"] / "w.pth", "--is_savenii", "--save_figs", "--z_spacing", "3"))
    return got, json.loads(out.getvalue().strip().splitlines()[-1])


def test_cli_eval_pth_equals_run_inference_and_saves_nifti(data, pth_run):
    got, printed = pth_run
    assert printed == got and set(got) == {"mean_dice", "mean_hd95"}

    inf = VolumeInferencer(make_predict_fn(data["model"], torch.bfloat16),
                           VolumeInferenceConfig(img_size=IMG, num_classes=9), device="cpu")
    preds = {}
    dice, hd = run_inference(inf, data["cases"], save_hook=lambda case, pred: preds.update({case["case_name"]: pred}))
    assert got == {"mean_dice": dice, "mean_hd95": hd}
    assert 0.0 <= dice <= 1.0 and np.isfinite(hd)

    cfg = cli.make_config(cli.build_argparser().parse_args(_argv(data, "w.pth", "--z_spacing", "3")))
    snap = cli.snapshot_path(cfg)
    for case in data["cases"]:
        name = case["case_name"]
        base = os.path.join(snap, "predictions", name)
        np.testing.assert_array_equal(tnifti.read_nifti(f"{base}_pred.nii.gz"), preds[name])
        np.testing.assert_array_equal(tnifti.read_nifti(f"{base}_img.nii.gz"), case["image"])
        np.testing.assert_array_equal(tnifti.read_nifti(f"{base}_gt.nii.gz"), case["label"])
        assert os.path.getsize(os.path.join(snap, "figures", f"te_{name}.jpg")) > 0


def test_cli_eval_npz_equals_pth(data):
    assert set(state_dict_from_npz(str(data["root"] / "w.npz"))) == set(data["sd"])
    sd = load_checkpoint(build_model(data["cfg"], device="cpu", seed=4), str(data["root"] / "w.npz")).state_dict()
    for k, v in data["sd"].items():
        assert torch.equal(sd[k], v), k  # values and shapes, the Nonlocal gates' 0-d w included


@pytest.mark.parametrize("argv, message", [
    (["bench", "--preset", "synapse"], "ROADMAP queue 1 items 1 and 5"),
    (["eval", "--preset", "synapse", "--mesh", "1,1,2,2"], "at most data,model,seq"),
    (["eval", "--preset", "synapse", "--coordinator", "localhost:1234"], "--coordinator needs --num_processes"),
])
def test_unported_modes_presets_and_options_exit(argv, message):
    """What the CLI does not run exits before any work: ``bench`` naming the
    ROADMAP item that ports it, a mesh of more axes than data, model and seq
    (``--mesh 1,1,2``, which exited naming item 11b before the seq axis was
    ported, runs: ``tests/test_torch_ring.py``), and a
    ``--coordinator`` without the host count and index it needs."""
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)


def test_train_model_stats_logs_the_stats_line(slim, tmp_path):
    """``train --model_stats``, which exited before its port, logs
    ``print_model_stats``' line for a (1, C, S, S) input at startup, equal to
    ``model_cost`` of the trained model (one epoch of ACDC at batch 2)."""
    _write_preset_data("acdc", tmp_path)
    argv = ["train", "--preset", "acdc", "--encoder", ENCODER, "--device", "cpu", "--no-amp", "--root_path",
            str(tmp_path), "--list_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"), "--batch_size", "2",
            "--max_epochs", "1", "--model_stats"]
    trainer = cli.main(argv)
    snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
    with open(os.path.join(snap, "log_train.txt")) as f:
        lines = [line.split("] ", 1)[-1] for line in f.read().splitlines() if "GFLOPs" in line]
    cost = model_cost(trainer.model, (1, 1, IMG, IMG))
    assert lines == [f"model: {cost['params_m']:.2f} M params, {cost['flops_g']:.2f} GFLOPs @ (1, 1, {IMG}, {IMG}), "
                     f"{cost['bytes_accessed_gb']:.2f} GB accessed"]


def _write_preset_data(preset, root):
    """Seeded data of ``preset`` under ``root``: a few ACDC slices and one test
    volume, or a skin cache whose test split holds four images."""
    if preset == "acdc":
        write_acdc(str(root), n_train=4, n_valid=1, n_test=1, depth=2, h=80, w=72)
    else:
        write_skin_cache(str(root), IMG, n=4, rows={"ham10000": 9004, "ph2": 104}[preset])


@pytest.mark.parametrize("mode, preset", [("train", "acdc"), ("eval", "acdc"), ("eval", "ham10000"), ("eval", "ph2")])
def test_acdc_and_skin_modes_run(mode, preset, slim, tmp_path):
    """The modes that exited before their port: ``train --preset acdc`` (one
    epoch at batch 2) writes its step, ``final`` and curve; ``eval`` of a
    seeded b0's ``.pth`` prints the JSON of its preset, equal to the metrics
    computed directly: ACDC's full-metric ``run_inference`` on unnormalised
    volumes, the skin presets' ``skin_test``."""
    _write_preset_data(preset, tmp_path)
    argv = [mode, "--preset", preset, "--encoder", ENCODER, "--device", "cpu", "--no-amp", "--root_path",
            str(tmp_path), "--list_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"), "--batch_size", "2"]
    cfg = cli.make_config(cli.build_argparser().parse_args(argv))
    if mode == "train":
        trainer = cli.main(argv + ["--max_epochs", "1"])
        snap = os.path.join(str(tmp_path / "out"), os.listdir(tmp_path / "out")[0])
        assert trainer.step == 2 and os.path.exists(os.path.join(snap, "steps", "2.pth"))
        assert os.path.exists(os.path.join(snap, "final.pth"))
        assert len(open(os.path.join(snap, "result.tsv")).read().splitlines()) == 2
        return
    model = build_model(cfg, device="cpu", seed=3)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "w.pth")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = cli.main(argv + ["--checkpoint", str(tmp_path / "w.pth")])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == got
    predict = make_predict_fn(model, torch.float32)
    if preset == "acdc":
        inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=IMG, normalize=False, num_classes=4),
                               device="cpu")
        dice, hd = run_inference(inf, list(ACDCDataset(str(tmp_path), str(tmp_path), "test", IMG).volumes()),
                                 full_metrics=True)
        assert got == {"mean_dice": dice, "mean_hd95": hd}
        return
    ds = SkinDataset(preset, str(tmp_path), "test", IMG)
    assert len(ds) == 4
    image = torch.from_numpy(np.stack([ds.get_eval(i)["image"] for i in range(4)]).transpose(0, 3, 1, 2).copy())
    label = np.stack([ds.get_eval(i)["label"] for i in range(4)])
    dice, acc, iou = skin_test(predict, [{"image": image[:2], "label": label[:2]},
                                         {"image": image[2:], "label": label[2:]}])
    assert got == {"dice": dice, "acc": acc, "iou": iou}


def test_checkpoint_directories_and_devices(data, slim, tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="pass --checkpoint"):
        cli.main(_argv(data, tmp_path))  # an empty directory
    with pytest.raises(FileNotFoundError, match="pass --checkpoint"):
        load_checkpoint(data["model"], str(tmp_path))
    assert os.listdir(tmp_path) == []  # the fallback creates nothing
    tagger = ocp.StandardCheckpointer()  # an Orbax tag directory, as the JAX package writes one
    tagger.save(str(tmp_path / "final"), {"step": np.zeros((), np.int32)}, force=True)
    tagger.wait_until_finished()
    for path in (tmp_path / "final", tmp_path):  # the tag, and a snapshot that holds it
        with pytest.raises(ValueError, match=r"no \['params'"):  # a tag without weights names them
            cli.main(_argv(data, path))
        with pytest.raises(ValueError, match=r"no \['params'"):
            load_checkpoint(data["model"], str(path))
    argv = _argv(data, data["root"] / "w.pth")
    argv.remove("--checkpoint")
    argv.remove(str(data["root"] / "w.pth"))
    with pytest.raises(FileNotFoundError, match="pass --checkpoint"):
        cli.main(argv + ["--output_dir", str(tmp_path / "none")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(data, data["root"] / "w.pth")
    del argv[argv.index("--device") : argv.index("--device") + 2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_native_edt_matches_scipy(rng):
    for shape, sampling in [((64, 80), None), ((64, 80), (1.0, 0.7)),
                            ((12, 32, 40), None), ((12, 32, 40), (2.5, 1.0, 1.0))]:
        m = rng.random(shape) < 0.9  # mostly foreground
        np.testing.assert_allclose(native.edt(m, sampling=sampling),
                                   ndimage.distance_transform_edt(m, sampling=sampling), atol=1e-9)


def test_native_edt_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "edt.cpp"
    bad.write_text("this is not C++\n")
    _, so_name, symbols = native.LIBRARIES["edt"]
    monkeypatch.setitem(native.LIBRARIES, "edt", (bad, so_name, symbols))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.edt(np.ones((4, 4), bool))


def test_nifti_copy_matches_jax(rng, tmp_path):
    for dtype in (np.float32, np.uint8):
        vol = (rng.standard_normal((5, 12, 10)) * 50).astype(dtype)
        ours, theirs = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
        tnifti.write_nifti(ours, vol, (1.0, 1.0, 2.5))
        jnifti.write_nifti(theirs, vol, (1.0, 1.0, 2.5))
        np.testing.assert_array_equal(jnifti.read_nifti(ours), vol)
        np.testing.assert_array_equal(tnifti.read_nifti(theirs), vol)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert jnifti.gzip.decompress(a.read()) == jnifti.gzip.decompress(b.read())
