"""The port's CLI: ``eval`` of a checkpoint on Synapse volumes.

    python -m cenet_tpu_torch.cli.main eval --preset synapse --checkpoint model.pth \\
        --root_path .../Synapse/test_vol_h5 --list_dir .../lists_Synapse [--device cpu]

Mirrors ``cenet_tpu/cli/main.py``: the same arguments (``build_argparser``,
``make_config``, ``snapshot_path`` are copies) plus ``--device``, the device
the model runs on (the card by default, the CPU only when asked). ``eval``
loads a ``.pth`` or JAX-format ``.npz`` checkpoint
(:mod:`cenet_tpu_torch.core.checkpoint`), runs :class:`VolumeInferencer` and
:func:`run_inference` over the ``test_vol`` list, optionally writes per-case
figures (``--save_figs``) and NIfTI files (``--is_savenii``, spacing
(1, 1, z_spacing)), and prints ``{"mean_dice": …, "mean_hd95": …}`` as its
last line. What is not ported yet exits with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np

# what exits, and the ROADMAP queue 1 item that ports it
NOT_PORTED = {
    "train": "the train mode is not ported yet (ROADMAP queue 1 item 5)",
    "bench": "the bench mode is not ported yet (ROADMAP queue 1 items 1 and 5)",
    "acdc": "the acdc preset's data and eval are not ported yet (ROADMAP queue 1 item 8)",
    "ham10000": "the skin presets' data and eval are not ported yet (ROADMAP queue 1 item 8)",
    "ph2": "the skin presets' data and eval are not ported yet (ROADMAP queue 1 item 8)",
    "mesh": "--mesh and --coordinator (multi-device and multi-host runs) are not ported yet (ROADMAP queue 1 item 11)",
}


def build_argparser():
    p = argparse.ArgumentParser("cenet-tpu-torch")
    p.add_argument("mode", choices=["train", "eval", "bench"])
    p.add_argument("--preset", required=True, choices=["synapse", "acdc", "ham10000", "ph2"])
    p.add_argument("--root_path", default=None)
    p.add_argument("--list_dir", default=None)
    p.add_argument("--output_dir", default="./model_out")
    p.add_argument("--checkpoint", default=None, help=".npz (JAX package format) or .pth (torch) to load")
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
    p.add_argument("--mesh", default=None, help="data[,model[,seq]] device mesh (not ported yet)")
    # eval-protocol surface (reference scripts/synapse.sh TEST uses scale_factors
    # 1.0,0.75,0.5 vs TRAIN's 0.8,0.4 — FEA depends on these, synapse.sh:74,103)
    p.add_argument("--scale_factors", default=None, help="comma floats, e.g. '1.0,0.75,0.5'")
    p.add_argument("--diffatt_num_heads", default=None, help="comma ints, e.g. '16,8,8'")
    p.add_argument("--skip_mode", default=None, choices=[None, "add", "cat"])
    p.add_argument("--skip_use_command", default=None)
    p.add_argument("--is_savenii", action="store_true", help="export predictions as .nii.gz (eval)")
    p.add_argument("--save_figs", action="store_true",
                   help="per-case image/GT/pred figures during eval (utils_synapse.py:86)")
    p.add_argument("--model_stats", action="store_true", help="FLOPs/bytes at startup (train only)")
    p.add_argument("--z_spacing", type=int, default=None)
    # multi-host initialization (not ported yet)
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


def run_eval(cfg, args, test_set=None) -> dict:
    """Synapse volume evaluation of ``args.checkpoint`` on ``args.device``;
    prints and returns ``{"mean_dice", "mean_hd95"}``. ``test_set`` (anything
    with ``volumes()`` yielding {image, label, case_name}) replaces the
    ``test_vol`` list under ``cfg.data``."""
    import torch

    from cenet_tpu_torch.core.checkpoint import ORBAX_NOT_PORTED, load_checkpoint
    from cenet_tpu_torch.core.device import resolve_device
    from cenet_tpu_torch.core.logging_utils import setup_logging
    from cenet_tpu_torch.evaluate.predict import make_predict_fn
    from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer, run_inference
    from cenet_tpu_torch.models.cenet import build_model

    snap = snapshot_path(cfg)
    ckpt = args.checkpoint or snap  # without --checkpoint: the snapshot's own checkpoints, as the JAX CLI
    if os.path.isdir(ckpt):
        raise NotImplementedError(ORBAX_NOT_PORTED)
    if not os.path.isfile(ckpt):
        raise FileNotFoundError(f"no checkpoint in {ckpt}; pass --checkpoint")
    device = resolve_device(args.device)
    root = logging.getLogger()
    before = list(root.handlers)
    log = setup_logging(snap, "eval")
    try:
        if test_set is None:
            from cenet_tpu_torch.data.synapse import SynapseDataset

            d = cfg.data
            test_set = SynapseDataset(d.root_path, d.list_dir, "test_vol", d.img_size, preload=False)
        model = build_model(cfg, device=device, seed=cfg.train.seed)
        load_checkpoint(model, ckpt, cfg.model.model_version)
        log.info("loaded checkpoint %s on %s", ckpt, device)
        compute_dtype = torch.bfloat16 if cfg.train.amp else torch.float32  # cenet_tpu/train/trainer.py:112
        inf = VolumeInferencer(
            make_predict_fn(model, compute_dtype),
            VolumeInferenceConfig(img_size=cfg.data.img_size, normalize=True, num_classes=cfg.model.num_classes),
            device=device,
        )
        dice, hd = run_inference(inf, list(test_set.volumes()), log=log, save_hook=_save_hooks(args, cfg, snap, log))
    finally:
        for h in [h for h in root.handlers if h not in before]:
            root.removeHandler(h)
            h.close()
    result = {"mean_dice": dice, "mean_hd95": hd}
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None, test_set=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.mode != "eval":
        raise SystemExit(NOT_PORTED[args.mode])
    if args.preset != "synapse":
        raise SystemExit(NOT_PORTED[args.preset])
    if args.mesh or args.coordinator:
        raise SystemExit(NOT_PORTED["mesh"])
    cfg = make_config(args)
    np.random.seed(cfg.train.seed)
    return run_eval(cfg, args, test_set)


if __name__ == "__main__":
    main()
