"""The model zoo through the port's ``cli train`` and ``cli eval`` on the CPU.

``python -m cenet_tpu_torch.cli.main train --device cpu`` with
``--model_version cenet_org`` (pvt_v2_b0) and with ``--encoder resnet18``
(CENet), on the slim configuration (64 px, fp32, drop-path 0) over four 64²
``.npz`` slices (batch 2) for one epoch. For each: the
trainer holds the zoo's model; its ``final`` tag loads strictly into a fresh
``build_model`` of the configuration; the snapshot directory is named with
the model version; and ``cli eval --checkpoint <snapshot>`` on one in-memory
volume prints CENetOrg's snapshot eval's metrics (its run evaluates after
the epoch) and, for the ResNet run (no snapshot eval: ``--eval_interval 2``),
the metrics of the ``final`` tag it loaded. Every weight stays finite: at
64 px a ResNet's last stage is 2 × 2, where a channel that a ReLU leaves
constant over an image has a zero std in dec4's CCU, whose ``sqrt`` gradient
the port takes as 0 (``nn.functional.std_sqrt``; NaN in the JAX package).

``cli eval`` also reads CENetOrg's weights as a JAX-format ``.npz`` (written
by the JAX package's ``_save_npz`` on a ``jax.eval_shape`` template, no JAX
compile) and prints the metrics of the same weights as a ``.pth``. And on a
ResNet backbone: ``freeze_bb`` keeps it fixed through a train step, and
``load_pretrained_encoder`` takes a ``.pth`` that the test writes from the
port's own ResNet with torchvision's keys (and its classifier's, reported
unused).
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.core.checkpoint import _save_npz
from cenet_tpu.core.config import get_preset as jget_preset
from cenet_tpu.train.trainer import build_model as jbuild_model
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.core.checkpoint import load_checkpoint, load_pretrained_encoder
from cenet_tpu_torch.models.cenet import CENet, CENetOrg, build_model
from cenet_tpu_torch.models.resnet import ResNet
from cenet_tpu_torch.train.trainer import Trainer
from torch_parity import variables_from_port

IMG, BATCH, SLICES = 64, 2, 4
MODELS = [("cenet_org", "pvt_v2_b0"), ("cenet", "resnet18")]


def _slim(get_preset):
    def preset(name):
        cfg = get_preset(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, drop_path_rate=0.0),
                           data=dataclasses.replace(cfg.data, img_size=IMG))

    return preset


@contextlib.contextmanager
def slim_presets():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "get_preset", _slim(tconfig.get_preset))
        yield


class Volumes:
    def __init__(self, cases):
        self.cases = cases

    def volumes(self):
        return iter(self.cases)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    rng = np.random.default_rng(0)
    names = []
    for i in range(SLICES):
        label = np.zeros((IMG, IMG), np.uint8)
        label[10:30, 12:40] = 1 + i % 8
        image = (label * 0.1 + rng.integers(-40, 40, (IMG, IMG)) / 100.0).astype(np.float32)
        names.append(f"case0001_slice{i:03d}")
        np.savez(root / f"{names[-1]}.npz", image=image, label=label)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    label = np.zeros((2, 72, 72), np.uint8)
    label[:, 20:50, 24:60] = 3
    image = (label * 0.1 + rng.integers(-40, 40, (2, 72, 72)) / 100.0).astype(np.float32)
    return dict(root=root, test_set=Volumes([{"image": image, "label": label, "case_name": "case0002"}]))


def _argv(mode, data, version, encoder, *extra, eval_interval=1):
    return [mode, "--preset", "synapse", "--model_version", version, "--encoder", encoder, "--device", "cpu",
            "--no-amp", "--root_path", str(data["root"]), "--list_dir", str(data["root"]),
            "--output_dir", str(data["root"] / "out"), "--max_epochs", "1", "--eval_interval", str(eval_interval),
            "--batch_size", str(BATCH), *extra]


def _main(argv, data):
    out = io.StringIO()
    with slim_presets(), contextlib.redirect_stdout(out):
        got = cli.main(argv, test_set=data["test_set"])
    return got, out.getvalue()


@pytest.mark.parametrize("version,encoder", MODELS)
def test_cli_train_and_eval_run_the_zoo(data, version, encoder):
    interval = 1 if version == "cenet_org" else 2  # the ResNet run evaluates once, in cli eval
    argv = _argv("train", data, version, encoder, eval_interval=interval)
    trainer, _ = _main(argv, data)
    assert isinstance(trainer.model, CENetOrg if version == "cenet_org" else CENet)
    assert isinstance(trainer.model.backbone, ResNet) == encoder.startswith("resnet")
    assert trainer.step == SLICES // BATCH and all(torch.isfinite(p).all() for p in trainer.model.parameters())
    with slim_presets():
        cfg = cli.make_config(cli.build_argparser().parse_args(argv))
    snap = cli.snapshot_path(cfg)
    assert f"_{version}_" in os.path.basename(snap)
    final = os.path.join(snap, "final.pth")
    fresh = load_checkpoint(build_model(cfg, device="cpu", seed=9), final, version)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    got, stdout = _main(_argv("eval", data, version, encoder, "--checkpoint", snap, eval_interval=interval), data)
    assert f"loaded checkpoint {final}" in stdout
    assert json.loads(stdout.strip().splitlines()[-1]) == got
    if interval == 1:
        last = open(os.path.join(snap, "result.tsv")).read().splitlines()[-1].split("\t")
        assert got == {"mean_dice": float(last[1]), "mean_hd95": float(last[2])}
    else:
        assert not os.path.exists(os.path.join(snap, "result.tsv"))
        assert set(got) == {"mean_dice", "mean_hd95"} and np.isfinite(got["mean_dice"])


def test_cli_eval_reads_a_jax_npz_of_cenet_org(data, tmp_path):
    with slim_presets():
        cfg = tconfig.get_preset("synapse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, model_version="cenet_org", encoder="pvt_v2_b0"))
    model = build_model(cfg, device="cpu", seed=4)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "w.pth")
    jcfg = jget_preset("synapse")
    jm = jbuild_model(jcfg.replace(model=dataclasses.replace(jcfg.model, model_version="cenet_org",
                                                             encoder="pvt_v2_b0")))
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x), jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 1)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    _save_npz(str(tmp_path / "w.npz"), variables_from_port(model, template, "cenet_org"))
    loaded = load_checkpoint(build_model(cfg, device="cpu", seed=5), str(tmp_path / "w.npz"), "cenet_org")
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded.state_dict()[k], v), k
    results = [_main(_argv("eval", data, "cenet_org", "pvt_v2_b0", "--checkpoint", str(tmp_path / f"w.{ext}")),
                     data)[0] for ext in ("npz", "pth")]
    assert results[0] == results[1] and set(results[0]) == {"mean_dice", "mean_hd95"}


def test_freeze_bb_and_pretrained_resnet_encoder(tmp_path, caplog):
    cfg = tconfig.get_preset("synapse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder="resnet18", freeze_bb=True, drop_path_rate=0.0),
                      train=dataclasses.replace(cfg.train, amp=False))
    s = IMG
    src = build_model(cfg, device="cpu", seed=7).backbone.state_dict()
    sd = {k: v for k, v in src.items() if not k.startswith("layer4.1.")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)  # an ImageNet classifier
    torch.save(sd, tmp_path / "resnet18.pth")
    trainer = Trainer(cfg, 10, device="cpu")
    report = load_pretrained_encoder(trainer.model, str(tmp_path / "resnet18.pth"))
    assert report["unused"] == ["fc.bias", "fc.weight"]
    assert report["missing"] == sorted(k for k in src if k.startswith("layer4.1."))
    assert "params not found" in caplog.text
    bb = {k: v.clone() for k, v in trainer.model.backbone.state_dict().items()}
    for k in sd:
        if k in bb:
            assert torch.equal(bb[k], sd[k]), k
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((2, 1, s, s)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 9, (2, s, s)))
    head = {k: v.clone() for k, v in trainer.model.named_parameters() if not k.startswith("backbone.")}
    trainer.train_step(images, labels)
    for k, v in trainer.model.backbone.named_parameters():
        assert torch.equal(v, bb[k]), k  # frozen (BatchNorm statistics still move in train mode)
    assert any(not torch.equal(v, head[k]) for k, v in trainer.model.named_parameters() if k in head)
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
