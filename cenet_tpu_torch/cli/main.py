"""The port's CLI: ``train`` and ``eval`` for all four workloads.

    python -m cenet_tpu_torch.cli.main train --preset synapse --root_path .../Synapse/train_npz \\
        --list_dir .../lists_Synapse [--resume] [--throughput] [--device cpu]
    python -m cenet_tpu_torch.cli.main eval --preset synapse [--checkpoint model.pth|orbax_dir|snapshot_dir] \\
        --root_path .../Synapse/test_vol_h5 --list_dir .../lists_Synapse [--device cpu]
    python -m cenet_tpu_torch.cli.main train|eval --preset acdc --root_path .../ACDC --list_dir .../lists_ACDC
    python -m cenet_tpu_torch.cli.main train|eval --preset ham10000|ph2 --root_path .../PH2

Mirrors ``cenet_tpu/cli/main.py``: the same arguments (``build_argparser``,
``make_config``, ``snapshot_path`` are copies) plus ``--device``, the device
the model runs on (the card by default, the CPU only when asked). Every model
of the zoo runs: ``--model_version cenet|cenet_org`` and ``--encoder``
pvt_v2_b0…b5 or resnet18…152.

``train`` is the JAX ``run_train``: the epoch loop with ``steps_per_call``
batches stacked into ``Trainer.multi_step`` and the epoch-end flush, logs and
scalars, a rotating step checkpoint every epoch, ``final``, the metric curves,
``--resume``, ``--pretrained_pth``, ``--model_stats`` (FLOPs and bytes of
a forward at startup, ``core/stats.py``) and ``--throughput``, whose JSON is
its last line; and each dataset's eval policy after an epoch: Synapse from epoch
T/2 every ``eval_interval`` epochs an ``epochN`` tag and a volume eval; ACDC
a per-slice val every epoch and, when it improves, a volume test, and
``best`` when that improves; HAM10000/PH2 the same cascade with the skin val
and test. ``eval`` loads a ``.pth`` or JAX-format ``.npz`` checkpoint, an
Orbax tag or step of the JAX package, or a snapshot directory's
``best``/``final``/last epoch/latest step over both packages' formats
(:mod:`cenet_tpu_torch.core.checkpoint`); ``train --resume`` continues a run
of either package from its latest step (or last tag), the JAX package's Orbax
TrainState, momentum and count included, read without JAX. Synapse and ACDC run
:class:`VolumeInferencer` and :func:`run_inference` over the test volumes
(ACDC unnormalised, with the full metrics), optionally with per-case figures
(``--save_figs``) and NIfTI files (``--is_savenii``, spacing (1, 1,
z_spacing)), and print ``{"mean_dice": …, "mean_hd95": …}``; the skin presets
run ``skin_test`` over the test split, optionally with contour overlays
(``--save_figs``), and print ``{"dice": …, "acc": …, "iou": …}``, as the last
line. What is not ported yet (``bench``) exits with the ROADMAP item that
ports it.

``--mesh data[,model[,seq]]`` runs either mode on the ``('data', 'seq',
'model')`` mesh of ``core/mesh.py`` (the JAX CLI's order on the command line,
JAX's layout of the ranks), one rank per process and device (``cuda:<local rank>``, or
the CPU under ``--device cpu``). Launched alone, this process is local rank 0
and starts the host's other ranks itself, as fresh processes of this module;
with ``--coordinator host:port``, host ``--process_id i`` of
``--num_processes P`` takes the global ranks i·L … i·L+L−1 (L ranks a host);
under ``torchrun`` (``RANK`` set) each process is one rank and starts none.
Only rank 0 logs, writes checkpoints and figures and prints the JSON line;
every rank loads. Every rendezvous and collective fails after
``core.mesh.DEFAULT_TIMEOUT_S``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# what exits, and the ROADMAP queue 1 item that ports it
NOT_PORTED = {
    "bench": "the bench mode is not ported yet (ROADMAP queue 1 items 1 and 5)",
}


def build_argparser():
    p = argparse.ArgumentParser("cenet-tpu-torch")
    p.add_argument("mode", choices=["train", "eval", "bench"])
    p.add_argument("--preset", required=True, choices=["synapse", "acdc", "ham10000", "ph2"])
    p.add_argument("--root_path", default=None)
    p.add_argument("--list_dir", default=None)
    p.add_argument("--output_dir", default="./model_out")
    p.add_argument("--checkpoint", default=None,
                   help=".npz (JAX package format), .pth (torch), an Orbax tag or step directory of the "
                        "JAX package, or a snapshot directory to load")
    p.add_argument("--device", default="cuda", help="device the model runs on: cuda (default) or cpu")
    p.add_argument("--pretrained_pth", default=None, help="pvt_v2_bX.pth encoder weights")
    p.add_argument("--model_version", default=None, choices=[None, "cenet", "cenet_org"])
    p.add_argument("--encoder", default=None,
                   help="backbone, e.g. pvt_v2_b2 / resnet50 (reference --encoder, main_synapse.py:139)")
    p.add_argument("--freeze_bb", action="store_true", default=None,
                   help="freeze backbone params (reference --freeze_bb)")
    p.add_argument("--steps_per_call", type=int, default=None, help="optimizer steps per call")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--base_lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--amp", action="store_true", default=None)
    p.add_argument("--no-amp", dest="amp", action="store_false")
    p.add_argument("--attn_impl", default=None, choices=[None, "xla", "chunked", "pallas", "ring"])
    p.add_argument("--eval_interval", type=int, default=None)
    p.add_argument("--throughput", action="store_true")
    p.add_argument("--resume", action="store_true", help="resume from the latest snapshot in the output dir")
    p.add_argument("--mesh", default=None,
                   help="data[,model[,seq]] mesh, e.g. '2', '2,2' or '1,1,2', one rank per device "
                        "(seq > 1 splits the tokens of the ring-attention sites: --attn_impl ring)")
    # eval-protocol surface (reference scripts/synapse.sh TEST uses scale_factors
    # 1.0,0.75,0.5 vs TRAIN's 0.8,0.4 — FEA depends on these, synapse.sh:74,103)
    p.add_argument("--scale_factors", default=None, help="comma floats, e.g. '1.0,0.75,0.5'")
    p.add_argument("--diffatt_num_heads", default=None, help="comma ints, e.g. '16,8,8'")
    p.add_argument("--skip_mode", default=None, choices=[None, "add", "cat"])
    p.add_argument("--skip_use_command", default=None)
    p.add_argument("--is_savenii", action="store_true", help="export predictions as .nii.gz (eval)")
    p.add_argument("--save_figs", action="store_true",
                   help="per-case image/GT/pred figures during eval (utils_synapse.py:86) "
                        "/ skin contour overlays (utils_skin.py:155-157)")
    p.add_argument("--model_stats", action="store_true",
                   help="FLOPs/bytes of a forward at startup (train only); param count is always printed")
    p.add_argument("--z_spacing", type=int, default=None)
    # multi-host initialization
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def make_config(args):
    from cenet_tpu_torch.core.config import get_preset

    cfg = get_preset(args.preset)
    model, train, data = cfg.model, cfg.train, cfg.data
    if args.model_version:
        model = dataclasses.replace(model, model_version=args.model_version)
    if args.encoder:
        model = dataclasses.replace(model, encoder=args.encoder)
    if args.freeze_bb:
        model = dataclasses.replace(model, freeze_bb=True)
    if args.attn_impl:
        model = dataclasses.replace(model, attn_impl=args.attn_impl)
    if args.scale_factors:
        model = dataclasses.replace(model, scale_factors=tuple(float(s) for s in args.scale_factors.split(",")))
    if args.diffatt_num_heads:
        model = dataclasses.replace(model, diffatt_num_heads=tuple(int(s) for s in args.diffatt_num_heads.split(",")))
    if args.skip_mode:
        model = dataclasses.replace(model, skip_mode=args.skip_mode)
    if args.skip_use_command:
        model = dataclasses.replace(model, skip_use_command=args.skip_use_command)
    if args.z_spacing is not None:
        data = dataclasses.replace(data, z_spacing=args.z_spacing)
    for field, val in [("max_epochs", args.max_epochs), ("batch_size", args.batch_size),
                       ("base_lr", args.base_lr), ("seed", args.seed), ("amp", args.amp),
                       ("eval_interval", args.eval_interval), ("steps_per_call", args.steps_per_call)]:
        if val is not None:
            train = dataclasses.replace(train, **{field: val})
    if args.root_path:
        data = dataclasses.replace(data, root_path=args.root_path)
    if args.list_dir:
        data = dataclasses.replace(data, list_dir=args.list_dir)
    return cfg.replace(model=model, train=train, data=data, output_dir=args.output_dir)


def snapshot_path(cfg) -> str:
    t = cfg.train
    return os.path.join(
        cfg.output_dir,
        f"{cfg.data.dataset}_{cfg.model.model_version}_e{t.max_epochs}_bs{t.batch_size}"
        f"_lr{t.base_lr}_s{t.seed}{('_' + cfg.tag) if cfg.tag else ''}",
    )


def _save_hooks(args, cfg, snap: str, log: logging.Logger):
    """The per-case ``save_hook`` of ``--save_figs`` and ``--is_savenii``, or None."""
    hooks = []
    if args.save_figs:
        # per-case image/GT/pred triptych, saved unconditionally by the
        # reference test loop (utils_synapse.py:86); flag-gated here
        from cenet_tpu_torch.evaluate.visualize import save_im_gt_pd

        fig_dir = os.path.join(snap, "figures")

        def fig_hook(case, pred):
            save_im_gt_pd(np.asarray(case["image"]), np.asarray(case["label"]), pred,
                          case.get("case_name", "case"), fig_dir)

        hooks.append(fig_hook)
        log.info("saving per-case figures to %s", fig_dir)
    if args.is_savenii:
        # reference --is_savenii: pred/img/gt exported per case with
        # (1, 1, z_spacing) spacing (utils_synapse.py:88-97)
        from cenet_tpu_torch.evaluate.nifti import write_nifti

        nii_dir = os.path.join(snap, "predictions")
        os.makedirs(nii_dir, exist_ok=True)
        zsp = float(cfg.data.z_spacing)

        def nii_hook(case, pred):
            name = case.get("case_name", "case")
            write_nifti(os.path.join(nii_dir, f"{name}_pred.nii.gz"), pred.astype(np.uint8), (1.0, 1.0, zsp))
            write_nifti(os.path.join(nii_dir, f"{name}_img.nii.gz"), case["image"].astype(np.float32), (1.0, 1.0, zsp))
            write_nifti(os.path.join(nii_dir, f"{name}_gt.nii.gz"), case["label"].astype(np.uint8), (1.0, 1.0, zsp))

        hooks.append(nii_hook)
        log.info("saving nii.gz predictions to %s", nii_dir)
    if not hooks:
        return None

    def save_hook(case, pred):
        for hook in hooks:
            hook(case, pred)

    return save_hook


@contextlib.contextmanager
def _logging(snap: str, name: str, lead: bool = True):
    """``setup_logging`` for one run; its handlers leave the root logger after
    it. Off the lead rank of a mesh: a logger that writes nothing."""
    from cenet_tpu_torch.core.logging_utils import setup_logging

    if not lead:
        quiet = logging.getLogger("cenet_tpu_torch.cli.quiet")
        quiet.propagate = False
        quiet.handlers = [logging.NullHandler()]
        yield quiet
        return
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        yield setup_logging(snap, name)
    finally:
        for h in [h for h in root.handlers if h not in before]:
            root.removeHandler(h)
            h.close()


def _test_set(cfg, test_set=None):
    """The test split of ``cfg.data.dataset``: Synapse's ``test_vol`` volumes
    (or ``test_set``, anything with ``volumes()`` yielding {image, label,
    case_name}, which replaces them), ACDC's test volumes, or the skin test
    split."""
    d = cfg.data
    if test_set is not None:
        if d.dataset != "synapse":
            raise ValueError(f"test_set replaces Synapse's test_vol list only, not the {d.dataset} test split")
        return test_set
    if d.dataset == "synapse":
        from cenet_tpu_torch.data.synapse import SynapseDataset

        return SynapseDataset(d.root_path, d.list_dir, "test_vol", d.img_size, preload=False)
    if d.dataset == "acdc":
        from cenet_tpu_torch.data.acdc import ACDCDataset

        return ACDCDataset(d.root_path, d.list_dir, "test", d.img_size, preload=False)
    from cenet_tpu_torch.data.skin import SkinDataset

    return SkinDataset(d.dataset, d.root_path, "test", d.img_size)


def _datasets(cfg, test_set=None):
    """(train, val, test) splits of ``cfg.data.dataset`` (``cenet_tpu/cli/main.py::_datasets``;
    Synapse has no val split); ``test_set`` as in :func:`_test_set`."""
    d = cfg.data
    if d.dataset == "synapse":
        from cenet_tpu_torch.data.synapse import SynapseDataset

        train, val = SynapseDataset(d.root_path, d.list_dir, "train", d.img_size), None
    elif d.dataset == "acdc":
        from cenet_tpu_torch.data.acdc import ACDCDataset

        train = ACDCDataset(d.root_path, d.list_dir, "train", d.img_size)
        val = ACDCDataset(d.root_path, d.list_dir, "valid", d.img_size)
    else:
        from cenet_tpu_torch.data.skin import SkinDataset

        train = SkinDataset(d.dataset, d.root_path, "train", d.img_size)
        val = SkinDataset(d.dataset, d.root_path, "val", d.img_size)
    return train, val, _test_set(cfg, test_set)


def _volume_eval(predict, te_ds, cfg, device, log=None, save_hook=None, mesh=None):
    """Volume evaluation (``cenet_tpu/cli/main.py::_volume_eval``): (mean dice,
    mean HD95) of ``predict`` over ``te_ds.volumes()``; Synapse normalises its
    input, ACDC does not and computes the full metrics (dice, HD95, Jaccard,
    ASD), as the JAX CLI sets them by dataset. Under a mesh every rank runs
    the predictions (``predict`` shares each chunk over the data axis), rank 0
    the metrics, and every rank returns rank 0's."""
    from cenet_tpu_torch.core.mesh import broadcast_floats
    from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer, run_inference

    dataset = cfg.data.dataset
    inf = VolumeInferencer(
        predict,
        VolumeInferenceConfig(img_size=cfg.data.img_size, normalize=dataset == "synapse",
                              num_classes=cfg.model.num_classes),
        device=device,
    )
    lead = mesh is None or mesh.rank == 0
    result = run_inference(inf, list(te_ds.volumes()), full_metrics=dataset == "acdc", log=log, save_hook=save_hook,
                           metrics=lead)
    return result if mesh is None else tuple(broadcast_floats(result or (0.0, 0.0), mesh.device))


def _acdc_val(predict, vl_ds, cfg, device) -> float:
    """ACDC per-slice val dice at the original resolution
    (``metrics_eval.val_single_volume``): each slice through
    :class:`VolumeInferencer` in chunks of ``batch_size``, unnormalised; the
    mean over slices of the mean dice of classes 1..K-1."""
    from cenet_tpu_torch.evaluate.metrics import dice_coefficient
    from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer

    num_classes = cfg.model.num_classes
    inf = VolumeInferencer(
        predict,
        VolumeInferenceConfig(img_size=cfg.data.img_size, chunk=cfg.train.batch_size, normalize=False,
                              num_classes=num_classes),
        device=device,
    )
    dices = []
    for i in range(len(vl_ds)):
        s = vl_ds.get_eval(i)
        image, label = s["image"], s["label"]
        if image.ndim == 2:
            image, label = image[None], label[None]
        pred = inf.predict_volume(image)
        dices.append(float(np.mean([dice_coefficient(pred == c, label == c) for c in range(1, num_classes)])))
    return float(np.mean(dices)) if dices else 0.0


def _skin_batches(ds, bs, device):
    """The skin split ``ds`` in order, in batches of ``bs``: {``image`` (B, 3, H,
    W) fp32 on ``device``, ``label`` (B, H, W) numpy}; one ``get_eval`` per index."""
    import torch

    n = len(ds)
    for i in range(0, n, bs):
        samples = [ds.get_eval(j) for j in range(i, min(i + bs, n))]
        image = np.ascontiguousarray(np.stack([s["image"] for s in samples]).transpose(0, 3, 1, 2))
        yield {"image": torch.from_numpy(image).to(device), "label": np.stack([s["label"] for s in samples])}


def _quick_val(predict, vl_ds, cfg, device) -> float:
    """Skin val: per-batch dice on the argmax (utils_skin.py:97-113)."""
    from cenet_tpu_torch.evaluate.skin import skin_val

    return skin_val(predict, _skin_batches(vl_ds, cfg.train.batch_size, device))


def _overlay_hook(args, snap: str, log: logging.Logger):
    """``skin_test``'s ``save_hook`` of ``--save_figs`` (GT green, prediction
    red, one PNG per test image, reference utils_skin.py:155-157), or None.
    Through the hook each batch is forwarded once."""
    if not args.save_figs:
        return None
    import itertools

    from cenet_tpu_torch.evaluate.visualize import skin_overlay

    fig_dir = os.path.join(snap, "figures")
    counter = itertools.count()

    def save_hook(batch, pred):
        images = batch["image"].cpu().numpy()
        for j in range(pred.shape[0]):
            skin_overlay(images[j], np.asarray(batch["label"][j]), pred[j],
                         os.path.join(fig_dir, f"te_{next(counter)}.png"))

    log.info("saving overlays to %s", fig_dir)
    return save_hook


class _NullWriter:
    """The scalar writer of a rank that writes nothing."""

    def scalar(self, *args):
        pass

    def image(self, *args):
        pass

    def close(self):
        pass


def run_train(cfg, args, test_set=None, mesh=None):
    """Training on ``args.device`` (``cenet_tpu/cli/main.py::run_train``) with
    the eval and checkpoint policy of ``cfg.data.dataset``; returns the
    :class:`Trainer`. ``test_set`` replaces Synapse's ``test_vol`` list of
    the snapshot evals, as in :func:`run_eval`. Under ``mesh`` this is one
    rank: its loader builds its rows of each batch, and rank 0 alone logs,
    writes and prints."""
    import torch

    from cenet_tpu_torch.core.checkpoint import CheckpointManager, load_pretrained_encoder
    from cenet_tpu_torch.core.device import resolve_device
    from cenet_tpu_torch.core.logging_utils import ScalarWriter, Throughput
    from cenet_tpu_torch.core.stats import count_params, print_model_stats
    from cenet_tpu_torch.data.loader import Loader, device_put_fn
    from cenet_tpu_torch.evaluate.skin import skin_test
    from cenet_tpu_torch.evaluate.visualize import plot_metric_curves
    from cenet_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    snap = snapshot_path(cfg)
    with _logging(snap, "train", lead) as log:
        log.info("config: %s", cfg)
        writer = ScalarWriter(os.path.join(snap, "tb")) if lead else _NullWriter()
        d = cfg.data
        tr_ds, vl_ds, te_ds = _datasets(cfg, test_set)
        bs = cfg.train.batch_size
        iters_per_epoch = len(tr_ds) // bs
        max_iterations = cfg.train.max_epochs * iters_per_epoch
        trainer = Trainer(cfg, max_iterations, iters_per_epoch=iters_per_epoch, device=device, mesh=mesh)
        log.info("model: %.2f M params", count_params(trainer.model) / 1e6)
        if mesh is not None:
            log.info("mesh: data=%d model=%d seq=%d, %d sharded tensors", mesh.data, mesh.model, mesh.seq,
                     len(trainer.tp_plan))
        if args.model_stats and lead:  # the same count on the card as on the CPU (core/stats.py)
            print_model_stats(trainer.model, (1, cfg.model.input_channels, d.img_size, d.img_size), log=log.info)
        pretrained = args.pretrained_pth
        if not pretrained and cfg.model.enc_pretrain:
            # reference default: train mode loads {base_ptdir}/{encoder}.pth
            # (encoder.py:75-84; forced off in eval mode, main_synapse.py:144)
            cand = os.path.join("pretrained_pth", "pvt", f"{cfg.model.encoder}.pth")
            if os.path.exists(cand):
                pretrained = cand
            else:
                log.warning("enc_pretrain=True but %s not found; training from scratch", cand)
        if pretrained:
            load_pretrained_encoder(trainer.model, pretrained, mesh=mesh, plan=trainer.tp_plan)
            log.info("loaded pretrained encoder from %s", pretrained)

        spc_cfg = max(cfg.train.steps_per_call, 1)
        loader = Loader(len(tr_ds), tr_ds.get_train, bs, seed=cfg.train.seed, num_threads=d.num_workers,
                        prefetch=spc_cfg + 2, put_fn=device_put_fn(device),
                        rows=None if mesh is None else (mesh.d, mesh.data))
        ckpt = CheckpointManager(snap, keep=cfg.train.ckpt_keep, write=lead)
        meter = Throughput()
        best_val = best_test = 0.0
        it = 0
        start_epoch = 0
        if args.resume and ckpt.has_any():
            # the whole train state (momentum and the step count included) is
            # restored, so the continued run equals an uninterrupted one; tags
            # serve when no step checkpoint exists
            if ckpt.latest_step() is not None:
                src = f"step {ckpt.latest_step()}"
                ckpt.restore(trainer)
            else:
                tag = ckpt.available_tags()[-1]
                ckpt.restore(trainer, tag=tag)
                src = f"tag {tag}"
            it = trainer.step
            start_epoch = it // max(iters_per_epoch, 1)
            log.info("resumed from %s at iter %d (epoch %d, momentum restored)", src, it, start_epoch)
        spc = max(1, min(cfg.train.steps_per_call, iters_per_epoch))
        pending = []
        curve_dice, curve_hd = [], []  # per-eval points for the end-of-training curves
        num_classes = cfg.model.num_classes

        def flush_pending():
            # epoch-boundary flush: run leftover (< spc) batches as single steps so
            # end-of-epoch eval/checkpoints see a fully-trained state
            nonlocal it
            while pending:
                b0 = pending.pop(0)
                trainer.train_step(b0["image"], b0["label"])
                meter.step(bs)
                it += 1

        for epoch in range(start_epoch, cfg.train.max_epochs):
            for batch in loader.epoch(epoch):
                if spc == 1:
                    loss = trainer.train_step(batch["image"], batch["label"])
                    meter.step(bs)
                    it += 1
                else:
                    pending.append(batch)
                    if len(pending) < spc:
                        continue
                    images = torch.stack([b["image"] for b in pending])
                    labels = torch.stack([b["label"] for b in pending])
                    pending = []
                    loss = trainer.multi_step(images, labels)
                    for _ in range(spc):
                        meter.step(bs)
                    it += spc
                if it % 20 < spc:
                    lv = float(loss)
                    lr = float(trainer.schedule(it))
                    log.info("iter %d epoch %d loss %.5f lr %.6f %.1f img/s", it, epoch, lv, lr,
                             meter.images_per_sec)
                    writer.scalar("info/criterion", lv, it)
                    writer.scalar("info/lr", lr, it)
                if it % 100 < spc:
                    # image/GT/prediction triptych every ~100 iters (main_synapse.py:285-293)
                    img0 = batch["image"][0].float().cpu().numpy()
                    img0 = (img0 - img0.min()) / max(img0.max() - img0.min(), 1e-6)
                    probs0 = trainer.eval_step(batch["image"][:1])[0].cpu().numpy()
                    pred0 = probs0.argmax(0) / max(num_classes - 1, 1)
                    gt0 = batch["label"][0].cpu().numpy() / max(num_classes - 1, 1)
                    try:
                        writer.image("train/Image", img0[:1], it)
                        writer.image("train/Prediction", pred0[None], it)
                        writer.image("train/GroundTruth", gt0[None], it)
                    except Exception as e:  # noqa: BLE001 — the writer's failure alone; training goes on
                        log.warning("triptych not written at iter %d (%s: %s)", it, type(e).__name__, e)
            flush_pending()
            # eval / checkpoint policies (reference: main_synapse.py:297-309,
            # main_acdc.py:270-283, main_skin.py:261-270)
            if d.dataset == "synapse":
                if (epoch + 1) >= cfg.train.max_epochs // 2 and (epoch + 1) % cfg.train.eval_interval == 0:
                    ckpt.save(it, trainer, tag=f"epoch{epoch + 1}")
                    dice, hd = _volume_eval(trainer.eval_step, te_ds, cfg, device, mesh=mesh)
                    writer.scalar("info/test_dice", dice, it)
                    writer.scalar("info/test_hd95", hd, it)
                    curve_dice.append(dice)
                    curve_hd.append(hd)
                    log.info("epoch %d snapshot: test dice %.4f hd95 %.4f", epoch + 1, dice, hd)
            elif d.dataset == "acdc":
                val_d = _acdc_val(trainer.eval_step, vl_ds, cfg, device)
                writer.scalar("info/val_dice", val_d, it)
                curve_dice.append(val_d)
                curve_hd.append(curve_hd[-1] if curve_hd else 0.0)
                log.info("epoch %d val dice %.4f", epoch, val_d)
                if val_d > best_val:
                    best_val = val_d
                    dice, hd = _volume_eval(trainer.eval_step, te_ds, cfg, device, mesh=mesh)
                    curve_hd[-1] = hd
                    log.info("epoch %d test dice %.4f hd95 %.4f", epoch, dice, hd)
                    if dice > best_test:
                        best_test = dice
                        ckpt.save_best(trainer, {"val_dice": val_d, "test_dice": dice, "epoch": epoch})
                        log.info("new best test dice %.4f (saved best)", dice)
            else:
                val_d = _quick_val(trainer.eval_step, vl_ds, cfg, device)
                writer.scalar("info/val_dice", val_d, it)
                curve_dice.append(val_d)
                curve_hd.append(0.0)
                log.info("epoch %d val dice %.4f", epoch, val_d)
                if val_d > best_val:
                    best_val = val_d
                    t_dice, t_acc, t_iou = skin_test(trainer.eval_step, _skin_batches(te_ds, bs, device))
                    log.info("epoch %d test dice %.4f acc %.4f iou %.4f", epoch, t_dice, t_acc, t_iou)
                    if t_dice > best_test:
                        best_test = t_dice
                        ckpt.save_best(trainer, {"val_dice": val_d, "test_dice": t_dice, "epoch": epoch})
                        log.info("new best test dice %.4f (saved best)", t_dice)
            # rotating step checkpoint (keep=N) so --resume restores the latest epoch
            # boundary with optimizer momentum intact
            ckpt.save(it, trainer)
        ckpt.save(it, trainer, tag="final")
        if curve_dice and lead:
            # end-of-training dice/hd95 curves + tsv (utils.py:18-37 via main_acdc.py:292)
            plot_metric_curves(curve_dice, curve_hd, snap)
            log.info("metric curves saved to %s/result.png|.tsv", snap)
        writer.close()
        log.info("training done; throughput %.1f img/s", meter.images_per_sec)
    if args.throughput and lead:
        print(json.dumps({"metric": "train_images_per_sec", "value": meter.images_per_sec}), flush=True)
    return trainer


def run_eval(cfg, args, test_set=None, mesh=None) -> dict:
    """Evaluation of ``args.checkpoint`` (a file, or a snapshot directory;
    without it the configuration's own snapshot) on ``args.device`` over the
    test split: Synapse and ACDC volumes print and return ``{"mean_dice",
    "mean_hd95"}``, the skin presets ``{"dice", "acc", "iou"}``. ``test_set``
    (anything with ``volumes()`` yielding {image, label, case_name}) replaces
    Synapse's ``test_vol`` list under ``cfg.data``. Under ``mesh`` every rank
    loads the weights (its heads of the sharded sites), forwards its rows of
    each chunk or batch, and returns rank 0's metrics; rank 0 prints them."""
    import torch

    from cenet_tpu_torch.core.checkpoint import load_checkpoint, snapshot_checkpoint
    from cenet_tpu_torch.core.orbax import is_orbax_checkpoint
    from cenet_tpu_torch.core.device import resolve_device
    from cenet_tpu_torch.core.mesh import broadcast_floats, shard_model_
    from cenet_tpu_torch.evaluate.predict import make_predict_fn, shard_rows
    from cenet_tpu_torch.evaluate.skin import skin_test
    from cenet_tpu_torch.models.cenet import build_model

    snap = snapshot_path(cfg)
    ckpt = args.checkpoint or snap  # without --checkpoint: the snapshot's own checkpoints, as the JAX CLI
    if os.path.isdir(ckpt):
        ckpt = snapshot_checkpoint(ckpt)  # an Orbax checkpoint; or best, final, the last epoch, the latest step
    if not (os.path.isfile(ckpt) or is_orbax_checkpoint(ckpt)):
        raise FileNotFoundError(f"no checkpoint in {ckpt}; pass --checkpoint")
    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    with _logging(snap, "eval", lead) as log:
        te_ds = _test_set(cfg, test_set)
        model = build_model(cfg, device=device, seed=cfg.train.seed)
        load_checkpoint(model, ckpt, cfg.model.model_version)
        log.info("loaded checkpoint %s on %s", ckpt, device)
        compute_dtype = torch.bfloat16 if cfg.train.amp else torch.float32  # cenet_tpu/train/trainer.py:112
        predict = make_predict_fn(model, compute_dtype)
        if mesh is not None:
            plan = shard_model_(model, mesh)
            log.info("mesh: data=%d model=%d seq=%d, %d sharded tensors", mesh.data, mesh.model, mesh.seq, len(plan))
            predict = shard_rows(predict, mesh)
        if cfg.data.dataset in ("synapse", "acdc"):
            hooks = _save_hooks(args, cfg, snap, log) if lead else None
            dice, hd = _volume_eval(predict, te_ds, cfg, device, log=log, save_hook=hooks, mesh=mesh)
            result = {"mean_dice": dice, "mean_hd95": hd}
        else:
            dice, acc, iou = skin_test(predict, _skin_batches(te_ds, cfg.train.batch_size, device),
                                       save_hook=_overlay_hook(args, snap, log) if lead else None)
            if mesh is not None:  # every rank computed them from the same gathered labels; rank 0's hold
                dice, acc, iou = broadcast_floats((dice, acc, iou), mesh.device)
            log.info("test dice %.4f acc %.4f iou %.4f", dice, acc, iou)
            result = {"dice": dice, "acc": acc, "iou": iou}
    if lead:
        print(json.dumps(result), flush=True)
    return result


def _mesh_config(args):
    from cenet_tpu_torch.core.mesh import MeshConfig

    parts = [int(x) for x in args.mesh.split(",")] if args.mesh else [-1]
    if len(parts) > 3:
        raise SystemExit(f"--mesh {args.mesh}: at most data,model,seq")
    data, model, seq = (parts + [1, 1])[:3]
    return MeshConfig(data=data, model=model, seq=seq)


def _run_rank(args, test_set, mcfg, coordinator: str, world: int, rank: int, local_rank: int):
    """One rank of a mesh run: join the process group, make the mesh, run the mode, leave."""
    from cenet_tpu_torch.core.mesh import init_distributed, make_mesh, shutdown_distributed

    device = "cpu" if args.device == "cpu" else f"cuda:{local_rank}"
    init_distributed(coordinator, world, rank, device=device)
    try:
        mesh = make_mesh(mcfg, device=device)
        cfg = make_config(args)
        np.random.seed(cfg.train.seed)
        if args.mode == "train":
            return run_train(cfg, args, test_set, mesh=mesh)
        return run_eval(cfg, args, test_set, mesh=mesh)
    finally:
        shutdown_distributed()


def run_meshed(args, argv: Sequence[str], test_set=None):
    """A ``--mesh``/``--coordinator`` run (or one rank of one under ``torchrun``):
    this process is one rank; launched alone, it starts the host's other ranks
    as fresh processes of this module (``RANK`` set for each) and waits for them
    after its own."""
    import torch

    from cenet_tpu_torch.core import mesh as M

    mcfg = _mesh_config(args)
    if "RANK" in os.environ:  # torchrun, or a rank that a launch of this CLI started
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        return _run_rank(args, test_set, mcfg, coordinator, int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                         int(os.environ.get("LOCAL_RANK", 0)))
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator needs --num_processes and --process_id (one command line per host)")
    hosts, host = args.num_processes or 1, args.process_id or 0
    cuda = torch.device(args.device).type == "cuda"
    devices = torch.cuda.device_count() if cuda else 1
    world = mcfg.data * max(mcfg.model, 1) * max(mcfg.seq, 1) if mcfg.data > 0 else hosts * devices
    if world % hosts:
        raise SystemExit(f"--mesh {args.mesh}: {world} ranks do not split over {hosts} hosts")
    local = world // hosts
    if cuda and local > devices:
        raise SystemExit(f"NCCL runs one rank per card: {local} ranks on this host but {devices} cards")
    coordinator = args.coordinator or f"127.0.0.1:{M.free_port()}"
    addr, port = coordinator.rsplit(":", 1)
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": addr, "MASTER_PORT": port,
           "PYTHONPATH": os.pathsep.join([root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    children = [subprocess.Popen([sys.executable, "-m", "cenet_tpu_torch.cli.main", *argv],
                                 env={**env, "RANK": str(host * local + j), "LOCAL_RANK": str(j)})
                for j in range(1, local)]
    try:
        result = _run_rank(args, test_set, mcfg, coordinator, world, host * local, 0)
        for c in children:
            if c.wait(timeout=M.DEFAULT_TIMEOUT_S) != 0:
                raise RuntimeError(f"a rank of the mesh exited with {c.returncode}")
        return result
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait(timeout=30)


def main(argv: Optional[Sequence[str]] = None, test_set=None):
    """Parse ``argv`` and run ``train`` (returns the :class:`Trainer`) or ``eval``
    (returns its metrics). ``test_set`` replaces Synapse's ``test_vol`` list."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    if args.mode == "bench":
        raise SystemExit(NOT_PORTED["bench"])
    if args.mesh or args.coordinator or "RANK" in os.environ:
        return run_meshed(args, argv, test_set)
    cfg = make_config(args)
    np.random.seed(cfg.train.seed)
    if args.mode == "train":
        return run_train(cfg, args, test_set)
    return run_eval(cfg, args, test_set)


if __name__ == "__main__":
    main()
