"""The port's ``cli train`` and ``cli eval`` for the ACDC and PH2 presets on the CPU.

Port only (no JAX): ``python -m cenet_tpu_torch.cli.main train --preset
acdc|ph2`` runs here with ``--device cpu`` on the slim model (CENet with
pvt_v2_b0 at 64 px, fp32, drop-path 0: the preset with its encoder, image
size, precision and drop-path cut) over seeded synthetic data
(``cenet_tpu_torch/tools/synthetic.py``): ACDC for two epochs over eight 80 × 72 train slices
at batch 2 (four iterations an epoch, stacked by ``steps_per_call``; lr 0.5), two
valid slices and one 3-slice test volume; PH2 for one epoch over a 104-image
``np/`` cache (80 train at batch 8, 20 val, 4 test). One run of each serves:

* its final state equals the port's ``Trainer`` stepped by hand over the same
  ``Loader`` batches, to the bit (weights, BatchNorm buffers, momentum,
  count);
* the val → test → ``best`` cascade: the val metric of each epoch and, when it
  improves, the test metric are computed directly on the hand-stepped
  trainer (``VolumeInferencer`` and the metrics for ACDC, ``skin_val`` and
  ``skin_test`` for PH2), and ``best.pth`` holds the state of the epoch they
  pick, with their numbers in ``metrics_best.json``; ``result.tsv`` holds the
  val curve (and for ACDC the test HD95 carried forward, for PH2 zeros);
* (ACDC, whose run has two epochs; the resume path is the same for every
  dataset) a ``--resume`` from the epoch-1 step of a copy of its snapshot
  ends in the same state to the bit;
* ``cli eval --checkpoint <snapshot>`` picks ``best`` and prints the metrics of
  the ``best`` weights computed directly: ``{"mean_dice", "mean_hd95"}`` from
  ``run_inference`` with the full metrics on unnormalised volumes for ACDC,
  ``{"dice", "acc", "iou"}`` from ``skin_test`` for PH2 (``--save_figs``
  writes one overlay per test image).
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu_torch.tools.synthetic import write_acdc, write_skin_cache
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.core.checkpoint import CheckpointManager, load_checkpoint
from cenet_tpu_torch.data.acdc import ACDCDataset
from cenet_tpu_torch.data.loader import Loader, device_put_fn
from cenet_tpu_torch.data.skin import SkinDataset
from cenet_tpu_torch.evaluate.metrics import dice_coefficient
from cenet_tpu_torch.evaluate.predict import make_predict_fn
from cenet_tpu_torch.evaluate.skin import skin_test, skin_val
from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer, run_inference
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.train.trainer import Trainer

IMG, ENCODER = 64, "pvt_v2_b0"
BATCH, EPOCHS = {"acdc": 2, "ph2": 8}, {"acdc": 2, "ph2": 1}


def _slim_preset(get_preset):
    def preset(name):
        cfg = get_preset(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, drop_path_rate=0.0),
                           data=dataclasses.replace(cfg.data, img_size=IMG))

    return preset


# ACDC's run trains at lr 0.5: from the JAX package's initial weights (small
# truncated normals in the heads) the slim model predicts no foreground in its
# first epochs at the preset's 0.01 (val dice 0 through epoch 5 of 8), so the
# cascade would never run a test; at 0.5 its val dice rises at epoch 1
ARGS = {"acdc": ("--base_lr", "0.5"), "ph2": ()}


def _argv(mode, preset, root, out, *extra):
    return [mode, "--preset", preset, "--encoder", ENCODER, "--device", "cpu", "--no-amp", "--root_path", str(root),
            "--list_dir", str(root), "--output_dir", str(out), "--max_epochs", str(EPOCHS[preset]), "--batch_size",
            str(BATCH[preset]), *ARGS[preset], *extra]


def _run(argv):
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(tconfig, "get_preset", _slim_preset(tconfig.get_preset))
        result = cli.main(argv)
        cfg = cli.make_config(cli.build_argparser().parse_args(argv))
    return result, out.getvalue(), cfg


def _skin_batches(ds, bs):
    for i in range(0, len(ds), bs):
        samples = [ds.get_eval(j) for j in range(i, min(i + bs, len(ds)))]
        yield {"image": torch.from_numpy(np.stack([s["image"] for s in samples]).transpose(0, 3, 1, 2).copy()),
               "label": np.stack([s["label"] for s in samples])}


class Direct:
    """The val and test metrics of one preset, computed without the CLI."""

    def __init__(self, preset, root):
        self.preset, self.root = preset, str(root)
        if preset == "acdc":
            self.val = ACDCDataset(self.root, self.root, "valid", IMG)
            self.test = ACDCDataset(self.root, self.root, "test", IMG, preload=False)
        else:
            self.val, self.test = SkinDataset("ph2", self.root, "val", IMG), SkinDataset("ph2", self.root, "test", IMG)

    def val_dice(self, predict) -> float:
        if self.preset == "ph2":
            return skin_val(predict, _skin_batches(self.val, BATCH["ph2"]))
        inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=IMG, chunk=BATCH["acdc"], normalize=False,
                                                              num_classes=4), device="cpu")
        dices = []
        for s in self.val.volumes():
            pred = inf.predict_volume(s["image"][None])
            dices.append(float(np.mean([dice_coefficient(pred == c, s["label"][None] == c) for c in (1, 2, 3)])))
        return float(np.mean(dices))

    def test_metrics(self, predict):
        if self.preset == "ph2":
            return skin_test(predict, _skin_batches(self.test, BATCH["ph2"]))
        inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=IMG, normalize=False, num_classes=4),
                               device="cpu")
        return run_inference(inf, list(self.test.volumes()), full_metrics=True)


def _state(trainer):
    return {**{f"model.{k}": v for k, v in trainer.model.state_dict().items()},
            **{f"opt.{n}.{s}": t for n, slots in trainer.optimizer.state.items() for s, t in slots.items()}}


def assert_same_state(got, want):
    assert got.step == want.step
    a, b = _state(got), _state(want)
    assert a.keys() == b.keys()
    for k in b:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module", params=["acdc", "ph2"])
def run(request, tmp_path_factory):
    """One ``cli train`` run with ``--throughput`` of the preset, and the
    same training stepped by hand with the cascade computed directly."""
    preset = request.param
    root = tmp_path_factory.mktemp(preset)
    if preset == "acdc":
        write_acdc(str(root), n_test=1, h=80, w=72)
    else:
        write_skin_cache(str(root), IMG, n=104)
    argv = _argv("train", preset, root, root / "out", "--throughput")
    trainer, stdout, cfg = _run(argv)

    direct = Direct(preset, root)
    ds = ACDCDataset(str(root), str(root), "train", IMG) if preset == "acdc" else SkinDataset("ph2", str(root),
                                                                                                 "train", IMG)
    ipe = len(ds) // BATCH[preset]
    epochs = EPOCHS[preset]
    hand = Trainer(cfg, epochs * ipe, iters_per_epoch=ipe, device="cpu")
    loader = Loader(len(ds), ds.get_train, BATCH[preset], seed=cfg.train.seed, num_threads=2,
                    put_fn=device_put_fn("cpu"))
    best_val = best_test = 0.0
    vals, hds, best, best_state = [], [], None, None
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            hand.train_step(batch["image"], batch["label"])
        vals.append(direct.val_dice(hand.eval_step))
        hds.append(hds[-1] if hds else 0.0)  # the curve's HD95 column: ACDC's last test HD95, skin zeros
        if vals[-1] > best_val:
            best_val = vals[-1]
            metrics = direct.test_metrics(hand.eval_step)
            if preset == "acdc":
                hds[-1] = metrics[1]
            if metrics[0] > best_test:
                best_test = metrics[0]
                best = {"val_dice": vals[-1], "test_dice": metrics[0], "epoch": epoch}
                best_state = {k: v.clone() for k, v in hand.model.state_dict().items()}
    return dict(preset=preset, root=root, argv=argv, trainer=trainer, stdout=stdout, cfg=cfg,
                snap=cli.snapshot_path(cfg), hand=hand, ipe=ipe, vals=vals, hds=hds, best=best, best_state=best_state,
                direct=direct)


def test_cli_train_equals_the_trainer_stepped_by_hand(run):
    assert run["cfg"].data.dataset == run["preset"] and run["cfg"].data.img_size == IMG and not run["cfg"].train.amp
    assert run["trainer"].step == EPOCHS[run["preset"]] * run["ipe"]
    assert any(s for s in run["trainer"].optimizer.state.values())  # momentum exists
    assert_same_state(run["trainer"], run["hand"])
    last = json.loads(run["stdout"].strip().splitlines()[-1])
    assert last["metric"] == "train_images_per_sec" and last["value"] > 0


def test_cascade_saves_best_on_the_epoch_computed_directly(run):
    snap, best = run["snap"], run["best"]
    assert best is not None
    with open(os.path.join(snap, "metrics_best.json")) as f:
        assert json.load(f) == best
    saved = torch.load(os.path.join(snap, "best.pth"), weights_only=True)["state_dict"]
    assert saved.keys() == run["best_state"].keys()
    for k, v in run["best_state"].items():
        assert torch.equal(saved[k], v), k
    mgr = CheckpointManager(snap)
    epochs = EPOCHS[run["preset"]]
    assert mgr.available_tags() == ["best", "final"]
    assert mgr.all_steps() == [run["ipe"] * (e + 1) for e in range(epochs)]
    rows = [line.split("\t") for line in open(os.path.join(snap, "result.tsv")).read().splitlines()]
    assert rows[0] == ["epoch", "dice", "hd95"] and [float(r[1]) for r in rows[1:]] == run["vals"]
    assert [float(r[2]) for r in rows[1:]] == run["hds"]
    assert run["preset"] == "acdc" or run["hds"] == [0.0] * epochs


@pytest.mark.parametrize("run", ["acdc"], indirect=True)
def test_resume_from_the_epoch1_step_equals_the_uninterrupted_run(run, tmp_path):
    copy = tmp_path / "out" / os.path.basename(run["snap"])
    shutil.copytree(run["snap"], copy)
    for name in (f"steps/{EPOCHS['acdc'] * run['ipe']}.pth", "final.pth"):
        os.remove(copy / name)
    argv = [a if a != str(run["root"] / "out") else str(tmp_path / "out") for a in run["argv"]]
    trainer, stdout, _ = _run(argv + ["--resume"])
    assert f"resumed from step {run['ipe']} at iter {run['ipe']} (epoch 1, momentum restored)" in stdout
    assert_same_state(trainer, run["trainer"])
    assert os.path.exists(copy / "final.pth")


def test_cli_eval_of_the_snapshot_picks_best(run):
    argv = ["eval", *run["argv"][1:-1], "--checkpoint", run["snap"], "--save_figs"]
    result, stdout, _ = _run(argv)
    assert f"loaded checkpoint {os.path.join(run['snap'], 'best.pth')}" in stdout
    assert json.loads(stdout.strip().splitlines()[-1]) == result
    model = load_checkpoint(build_model(run["cfg"], device="cpu", seed=5), os.path.join(run["snap"], "best.pth"))
    for k, v in run["best_state"].items():
        assert torch.equal(model.state_dict()[k], v), k
    metrics = run["direct"].test_metrics(make_predict_fn(model, torch.float32))
    if run["preset"] == "acdc":
        assert result == {"mean_dice": metrics[0], "mean_hd95": metrics[1]}
        assert metrics[0] == run["best"]["test_dice"]
    else:
        assert result == {"dice": metrics[0], "acc": metrics[1], "iou": metrics[2]}
        assert sorted(os.listdir(os.path.join(run["snap"], "figures"))) == [f"te_{i}.png" for i in range(4)]
