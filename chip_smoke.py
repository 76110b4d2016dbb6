"""Smoke run of the PyTorch/CUDA port on one card: build, check, drive, report.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports nothing of JAX. Two main paths
run, volume inference and training (and last the ACDC and PH2 workloads
through the CLI), each on two routes of the DSEB sites' diff attention: the
interleaved route (K1, K3) the model takes, and the split-group route (K5,
K6) of ``router.diff_attention_core``, selected here by
rebinding ``router.diff_attention_interleaved`` (``split_route``); training
also runs the split route with K7 and K8 in place of K6 and K4. Both paths
run a third time with K9, K11 and K12 swapped in at their own sites
(``swapped_ops``: RMSNorm, depthwise and small-channel convolutions, which no
configuration of either package routes), and a rotary ``MultiheadDiffAttn``
runs K10. Phases:

1. print the card's name and power limit, read its SM count and maximum SM
   clock (the special-function units' rate of exponentials, for each attention
   kernel's ``exp_ms``), and build every kernel of both paths from
   ``cenet_tpu_torch/csrc`` (one ``nvcc`` per source, all in parallel),
   printing ``ptxas``'s registers and spills of the wide K2/K4's wgmma kernel
   instances and of the wide K1/K3's kernels;
2. hold each forward kernel (K1, K2, K5) against its plain PyTorch twin at
   every main-path shape (batch 2; fp32 with TF32 off and bf16), then at a
   32-slice chunk in bf16 (against the twin in slices of 2), K5 also against
   K1 on the same inputs, check that two runs there are bit-identical, and time
   kernel, twin and the PyTorch library call there (K1 also by device time,
   ``tools/device_time.py::graph_ms``); K1 and K3 also at the ACDC and skin
   presets' DSEB1 and DSEB2 head dims (``DIFF_SITES`` tagged ``acdc`` and
   ``skin``: d, dv = 16, 32 and 32, 64; 32, 64 and 64, 128), and K2 at a
   ResNet-50 CENet's Nonlocal sites (``ATTN_SITES`` tagged ``resnet50``: dec1
   at 56² with d = dv = 256, dec2 at 28² with 512, the wide wgmma designs),
   with their device time, the backend SDPA picks there and SDPA's device time
   (the loss factor device against device); then time plain math
   (``router.plain_attention``) against K2 in bf16 at dec1's head dims for
   maps of 8–64 MB, where the router's 32 MB rule draws its line;
   2b. the same for the backward kernels (K3, K4 at every site; K6, K7 at the
   DSEB sites and K8 at the dec1 site that training routes; K4 also at
   ResNet-50's dec1, wide, by device time too, beside SDPA's backward by
   device time: a graph of its forward and backward less one of its forward)
   on their gradients,
   in max-abs and in norm, and dλ for the diff kernels, at batch 2; at the
   training batch of 8, forward and backward kernels in fp32 and bf16 against
   the twins in slices of 2, the backward's times in bf16 (K3 also by device
   time), and whether two
   runs on the same inputs are bit-identical (required of every backward that
   sums without atomics: K3, K4, K7; of K8 in dk and dv and of K6 in dq and
   dλ, whose repeat runs are also held to the twin); K6 is also held against
   K7 on the same inputs, under the twin's limits;
   2c. K9, K11 and K12 against their twins at every site shape of the swapped
   paths (batch 2, and the 32-slice chunk or the training batch of 8; fp32 and
   bf16; K11's dw with x and g in the layouts that one train-mode backward of
   the model at batch 2 hands over, recorded here), repeat-run bit-identity
   of K11's forward and dw and of K12's forward, dx and dw, and their times
   beside the bound and the library call (K9 and K11's dw also by device
   time, beside the library call's: a CUDA graph of calls on copies of its
   inputs that pass twice the L2, ``tools/device_time.py``; K9's sum over its
   three sites against its bound);
3. slice parity: a seeded CENet-b2 (Synapse preset) on 2 slices at 224², fp32
   on the card (kernels routed) against fp32 on the CPU (twins), then bf16;
   3b. train-step parity: one fp32 forward/backward of the same model in train
   mode on 2 labelled images, card (kernels) and CPU (twins) each against the
   same step in float64 on the CPU; then at batch 8 the card's kernels against
   its twins;
   3c. the split route's train step: one fp32 step at batch 8 on the split
   route (K5, K6) against the interleaved route from the same weights and
   batch, then the same with K7 and K8 swapped in for K6 and K4;
   3d. the swapped train step (inside phase 3b): fp32 at batch 2 and at
   batch 8, each held against a float64 run of the step, and at batch 8 against
   the unswapped step;
4. the volume path: ``VolumeInferencer`` + ``run_inference`` in bf16 on two
   seeded synthetic CT cases (64 × 512 × 512, intensities in [0, 1], labels
   0–8), with the kernel launch counts of that run, slices/s, and step-event
   and back-zoom ms a chunk;
   4b. the split route's volume path: one bf16 chunk through ``make_predict_fn``
   on both routes, required equal to the bit (K5 launches K1's kernel), and
   one synthetic case through ``VolumeInferencer`` on both routes, with the
   split run's launch counts and slices/s, and the interleaved chunk's
   distance from the same chunk with K1's twin at the DSEB sites (measured
   only);
   4c. the same with K9, K11 and K12 swapped in (fp32 and bf16 chunks), and
   the bf16 chunk's forward timed with CUDA events beside the unswapped one;
   4d. the CLI: ``cenet_tpu_torch.cli.main`` ``eval`` in-process on phase 4's
   cases with a seeded CENet-b2's ``.pth`` and ``--is_savenii`` (``.npy.h5``
   files where ``h5py`` is installed, else the cases in memory), its per-class
   metrics read back from phase 4's: K1 and K2 launched as counted, its JSON
   line equal to ``run_inference`` on the same weights, the NIfTI files read
   back equal, HD95 with the native EDT within 1e-9 of scipy's; then every
   transfer mode and the host zoom, serial and overlapped, on the same cases
   (labels only): slices/s, step-event and back-zoom ms a chunk, float32
   serial = overlapped to the bit, float16 and host zoom ≥ 99.9% agreement;
   and on one HU-like integer case uint16 = float32 to the bit;
5. where one chunk's time goes: the bf16 forward of 32 slices timed with CUDA
   events, and its device time by kernel from ``torch.profiler``, which must
   show K1's and K2's tensor-core kernels as often as the launch counts say
   and no CUDA-core instance of either;
6. the training path: 64 synthetic 512² slices written as ``.npz`` with a
   ``train.txt``, then ``SynapseDataset`` → ``Loader`` → ``Trainer.train_step``
   with the Synapse preset (batch 8, bf16, SGD poly, BoundaryDoU, drop-path
   0.1): img/s through the loader, the wait on it, the step's wall time on a
   resident batch, every loss, peak memory and the launch counts of the run;
   6b. the CLI's train mode (run last, after phase 8, on phase 6's slices:
   run before phase 8, it was followed by a phase-8 forward profile that lost
   one of K10's two kernel records in all three tries):
   ``cenet_tpu_torch.cli.main`` ``train`` in-process on phase 6's 64
   slices for two epochs with a snapshot eval after each (two seeded 16 × 512²
   cases in memory) and ``--throughput``, then ``eval --checkpoint`` of its
   snapshot: K1–K4 launched as its 16 steps and 4 eval chunks count them, its
   tags, step files, curves and finite losses, eval's JSON equal to the last
   snapshot's; then, in fresh processes, two epochs against a ``--resume``
   from the epoch-1 step, equal to the bit under the determinism settings
   (``CUBLAS_WORKSPACE_CONFIG``, deterministic cuDNN and algorithms), and
   measured without them; img/s by ``--throughput`` beside phase 6's;
   6c. the ACDC workload (run after 6b): ``cli train --preset acdc`` for two
   epochs at full width on seeded ACDC-like files (64 train and 4 valid
   slices of 256 × 216, two 10-slice test volumes) and ``cli eval`` of its
   snapshot: launches as ``PRESET_PER_UNIT`` counts the steps, val chunks and
   the cascade's test chunks, the val → test → ``best`` cascade fired on
   epoch 0, eval's JSON equal to ``run_inference`` (full metrics,
   unnormalised) on the ``best`` weights loaded apart, and one bf16 batch of 8
   through the kernels held against the card's plain math;
   6d. the PH2 workload: the same for ``--preset ph2`` (one epoch) on a seeded
   200-image ``np/`` cache at 224², eval's JSON ``{"dice", "acc", "iou"}``
   equal to ``skin_test`` on the ``best`` weights;
   6e. the model zoo through the CLI: ``cli train --preset synapse
   --model_version cenet_org`` (pvt_v2_b2) at full width for three steps
   with a snapshot eval of one seeded 16 × 512² case, then ``cli eval`` of its
   snapshot: launches as the router's rule predicts them for the model's
   sites (``zoo_per_unit``), finite losses, eval's JSON equal to
   ``run_inference`` on the ``final`` weights and to the snapshot's, and one
   bf16 batch of 8 through the kernels held against the plain math;
   6f. the same with ``--encoder resnet50`` (CENet): K1 at DSEB1–3 (d, dv =
   32, 64 and 64, 128), K2 and K4 at dec1 (d = dv = 256) and K2 at dec2 in the
   eval chunk (512);
   6g. the rest of the one-card training surface (run after 6b, on phase 6's
   slices), the Synapse preset at full width: two steps with ``train.remat``
   against two without from the same state and generator seed (drop-path
   0.1), in a fresh process under 6b's determinism settings, equal to the
   bit; a step of each here, with K1–K4 launched as without remat, its peak
   memory and step ms; the remat step on the swapped route with 86 K11
   forwards (the 16 PVT ``DWConv``s again in the recompute); ``ProfilerHook``
   over two steps, its trace naming K1–K4's tensor-core kernels;
   ``assert_finite`` and ``tree_norm`` of the trained state; ``cli train
   --model_stats`` for one epoch, its GFLOPs line equal to ``model_cost`` of
   the model on the CPU, beside what ``FlopCounterMode`` reads of the card's
   forward with its sites routed; ``device_augment`` on eight seeded 512²
   slices against the CPU for the same choices, with its img/s beside the
   host path's;
   6h. the ``('data', 'model')`` mesh (run after 6g, on phase 6's slices), the
   Synapse preset, TF32 off for the fp32 comparisons: two ranks in fresh
   processes share the card over gloo (``init_distributed(backend="gloo")``)
   with meshes (2, 1) and (1, 2), two fp32 SGD steps each against the
   one-process steps (losses to rtol 2e-4, weights and BatchNorm statistics
   to 5e-4 max-abs, JAX's own DP/TP limits; the parameter updates and the
   SGD slots, the gradient path, to 1e-3 of their whole norm and 1e-2 of
   each tensor's), then one bf16 step each whose
   per-rank launches of K1–K4 must equal the one-process step's (the kernels
   built here before, not by the ranks); meanwhile, in this process, NCCL at
   one rank with mesh (1, 1) under the same limits, and ``cli train --mesh
   1`` for one epoch and ``cli eval --mesh 1`` of its snapshot, its JSON equal
   to ``cli eval`` without a mesh to 1e-6; the ``kernels`` line's
   ``mesh_launches`` holds the ranks' launches;
   6i. the ``seq`` axis and ring attention (run after 6h), the Synapse preset
   at 448², batch 2, TF32 off for the fp32 comparisons: two ranks in fresh
   processes share the card over gloo with the mesh (1, 1, 2) and
   ``attn_impl='ring'`` (gloo's point-to-point reads host memory, so the
   ring's hop goes through host copies there): (a) the ring core alone at
   dec1's and DSEB1's 112² shapes, K2 and K4 on each of its two hops, held on
   each rank's token block against the kernels' twins under phases 2 and
   2b's fp32 and bf16 limits; (b) two fp32 SGD steps against the one-process
   steps (K1–K4 routed) under 6h's limits, the seq ranks' weights and
   BatchNorm statistics equal to the bit after them; (c) one bf16 step whose
   launches a rank must be ``RING_PER_STEP`` (26 K2, 26 K4: 13 ring sites,
   two hops; no K1/K3), its peak memory beside the one-process step's;
   meanwhile in this process (d) ``cli eval --mesh 1,1,2 --attn_impl ring`` on
   phase 4's cases at 224² (its mode function over a gloo group, this process
   rank 0), labels agreeing with phase 4's on ≥ 99.9% of voxels, equal on
   both ranks, 18 K2 a chunk on each; then rank 0 takes the one-process steps
   and (e) one bf16 step with ``'ring'`` and no mesh, whose fallback sites
   must launch the one-process step's K1–K4; the ``kernels`` line's
   ``ring_launches`` holds the ranks' launches (the step's and the eval's);
   6j. the Orbax bridge (run after 6h, on phase 6's slices and phase 4's
   cases), with no JAX: the committed CENet-b2 TrainState that the JAX
   package wrote (``tests/torch_orbax_data``, step 37) read by the port's own
   OCDBT/zarr reader and zstd decoder (built from its source here), every
   leaf equal to its manifest's sha256 and, bridged onto a ``Trainer`` on
   the card, every tensor and SGD slot equal to the bit to its leaf in the
   port's layout; ``cli eval --checkpoint`` of the step (K1 and K2 as
   counted) and ``cli train --resume`` from a copy of it (resumed at iter
   37, two steps launching K1–K4, finite losses); the read's seconds and
   decoded MB/s; the ``kernels`` line's ``orbax_launches`` holds both runs';
   6k. K1 and K3 past head dim 128 (run last, after 6f; the wide designs of
   ``csrc/diff_attention_wide.cuh``): (a) K1 and K3 at ``WIDE_SITES``, the
   diff sites past 128 that the presets' paths route at their own batches
   (PH2 on a ResNet-50: DSEB1 at d, dv = 128, 256 and DSEB2 at 256, 512,
   batch 8; ACDC on a ResNet-50: DSEB2 at 128, 256, batch 8; ACDC on PVT-b2:
   DSEB3 at 80, 160, batch 64), held against the twins at batch 2 in fp32 and
   bf16 and at the site's batch in bf16, repeat runs equal to the bit, with
   their times beside the twin's, two SDPA calls' (and the backend SDPA
   took), the bound and the design's FLOPs over it; (b) ``cli train --preset
   ph2 --encoder resnet50`` for one epoch on phase 6d's seeded cache and
   ``cli eval`` of its ``final.pth``, launches as ``zoo_per_unit`` predicts,
   K1/K3 at both wide widths in every step (counted by head dims,
   ``diff_widths``), finite losses and JSON; (c) one bf16 ``Trainer`` step of
   the ACDC preset (CENet-b2) at a batch of 64, where DSEB3 is routed (and
   the PVT's stage-1 attention), launches as predicted, its ms and peak
   memory; (d) one fp32 step of PH2's CENet-resnet50 at batch 2, the kernels
   (DSEB1 on the wide fp32 K1/K3, dec1 on the wide K2/K4) against the twins
   on the card and both against the twins in float64 on the card; the
   ``kernels`` line's ``wide_sites``, ``wide_widths`` and ``wide_launches``
   hold what it measured;
7. where one training step's time goes: ``torch.profiler`` over one bf16 step
   (the card's busy time, and the host's), which must show the tensor-core
   kernels of K1–K4 and no CUDA-core instance of any of them;
   7b. ten resident bf16 steps of phase 6's trainer on the split route: step
   ms, launch counts, and one profiled step beside phase 7's, which must show
   K5 on K1's tensor-core kernel and K6's tensor-core kernel (two per step),
   and no K3 and no CUDA-core instance of K6;
   7c. the same as phase 6's steps with K9, K11 and K12 swapped in: the
   layouts of x and g of the step's 35 K11 dw calls (required equal to phase
   2c's), and a profile with phase 7's designs, K12's tensor-core forward
   (four per step, and four more for the backward's dx), its tensor-core dw
   (four), K11's tiled forward (70: 35 forwards, 35 dx) and tiled dw (35, by
   the routes the wrapper counts), and no bf16 instance of K12's CUDA-core
   forward or backward;
   7d. phase 7b with K7 and K8 swapped in for K6 and K4
   (``split_route(swap_backwards=True)``): step ms, launch counts, and one
   profiled step, which must show K7's tensor-core kernels (K3's dq kernel
   and the dk/dv kernel with split dv rounding) and K8's fused tensor-core
   kernel exactly as counted, and no CUDA-core instance of either;
8. the rotary path: ``MultiheadDiffAttn(use_rotary=True)`` at DSEB1's width,
   batch 8, with K10 for its interleaved rotary, against the plain module,
   K10 equal to the plain rotary to the bit, and a profile that shows K10's
   kernel twice per forward and, for calls on the fp32 tables (profiled in a
   fresh process, where the profiler keeps their records), alone.

Any failed phase raises, so the exit code is not 0 and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``; the two before it
hold the per-kernel record and the card's name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

from cenet_tpu_torch.core import mesh as M  # noqa: E402
from cenet_tpu_torch.core.config import get_preset  # noqa: E402
from cenet_tpu_torch.data import augment  # noqa: E402
from cenet_tpu_torch.data.loader import Loader, device_put_fn  # noqa: E402
from cenet_tpu_torch.data.synapse import SynapseDataset  # noqa: E402
from cenet_tpu_torch.evaluate import volume as VOL  # noqa: E402
from cenet_tpu_torch.evaluate.predict import make_predict_fn  # noqa: E402
from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer, run_inference  # noqa: E402
from cenet_tpu_torch.models.cenet import build_model  # noqa: E402
from cenet_tpu_torch.nn import layers as L  # noqa: E402
from cenet_tpu_torch.nn.attention import MultiheadDiffAttn  # noqa: E402
from cenet_tpu_torch.ops import attention_kernels as K  # noqa: E402
from cenet_tpu_torch.ops import binding, build, router  # noqa: E402
from cenet_tpu_torch.ops import depthwise as DWK  # noqa: E402
from cenet_tpu_torch.ops import rms_norm as RMS  # noqa: E402
from cenet_tpu_torch.ops import rotary as ROT  # noqa: E402
from cenet_tpu_torch.ops import smallc_conv as SCK  # noqa: E402
from cenet_tpu_torch.tools.device_time import graph_ms, rotated  # noqa: E402
from cenet_tpu_torch.tools.synthetic import write_acdc, write_skin_cache  # noqa: E402
from cenet_tpu_torch.train.losses import Criterion  # noqa: E402
from cenet_tpu_torch.train.trainer import Trainer  # noqa: E402

DEV = torch.device("cuda")
CHUNK = 32
TRAIN_B = 8  # the Synapse preset's training batch
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM dense bf16 FLOP/s and HBM bytes/s
# Limits on the max abs error of (o, lse) against the twin in fp32 on the same
# inputs. fp32: only the order of summation differs, so 1e-4 on both. bf16: the
# LSE stays fp32 (1e-4); o is set per site by bf16_o_limit.
TOL_FP32 = 1e-4
BF16_REL = 2.0**-8  # rounding to bf16 (8 significant bits) moves x by at most 2^-8·|x|


def amax(t) -> float:
    return float(t.abs().max())


def rel_norm(got, want) -> float:
    """‖got − want‖ / ‖want‖ over all elements, in fp32."""
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


def piece(tensors, i, step=2):
    """Batch rows i … i+step of each tensor (0-d tensors, such as λ, whole)."""
    return [t[i:i + step] if t.ndim else t for t in tensors]


def in_slices(check_fn, kernel, args, got, where, step=2):
    """``check_fn`` over the batch in slices of ``step`` (the twins' N×M maps at
    the main path's batch are too large at once); every slice must pass. Returns
    the largest reading of each kind, and the sum of the twin's dλ."""
    readings = [check_fn(kernel, piece(args, i, step), piece(got, i, step), f"{where}, batch rows {i}:{i + step}")
                for i in range(0, args[0].shape[0], step)]
    return {k: (sum if k == "dlam_want" else max)(r[k] for r in readings) for k in readings[0]}


def bf16_o_limit(want, want_w) -> float:
    """Limit on max |o − want| for a bf16 kernel. ``want`` is the fp32 twin on
    the bf16 inputs; ``want_w`` the same twin with w rounded to bf16 before the
    product, as the kernel rounds it. Two bf16 half-ulps of max |want|: one for
    rounding o, one for the w values whose rounding goes the other way because
    the kernel's fp32 w differs from the twin's in its last bits; plus what
    rounding w costs, as the twin itself computes it."""
    return 2 * BF16_REL * amax(want) + amax(want_w - want)


def fwd_check(kernel, args, got, where):
    """Hold a forward kernel's ``got`` = (o, LSEs) against the fp32 twin on the
    same (rounded) inputs; raises past the limits, returns the readings."""
    want = plain_fn(kernel)(*[a.float() for a in args])
    e_o = amax(got[0].float() - want[0])
    e_l = max(amax(g - w) for g, w in zip(got[1:], want[1:]))
    out = {"err_o": e_o, "err_lse": e_l, "max_abs_o": amax(want[0])}
    lim = TOL_FP32
    if args[0].dtype == torch.bfloat16:
        # the twin with v kept in bf16 rounds w to bf16 as the kernel does
        want_w = plain_fn(kernel)(*[a if i == v_index(kernel) else a.float() for i, a in enumerate(args)])[0]
        lim = bf16_o_limit(want[0], want_w)
        out["w_term"], out["err_o_vs_w_rounded"] = amax(want_w - want[0]), amax(got[0].float() - want_w)
    out["limit_o"], out["share_o"] = lim, e_o / lim
    check(e_o <= lim and e_l <= TOL_FP32,
          f"{kernel} at {where}: o err {e_o} (limit {lim}), lse err {e_l} (limit {TOL_FP32})")
    return out


# Main-path sites of a Synapse chunk: (site, h, n, d, dv). Diff attention: q/k
# (B, 2h, N, d), v (B, h, N, 2d), and for the split kernel the head views
# q[:, 0::2] … k[:, 1::2] of the same q/k; attention: q/k (B, h, N, d), v (B, h, N, dv).
# The ACDC preset's DSEB heads (4, 4, 4) and the skin presets' (2, 2, 2) on the
# same widths give the sites tagged with their preset: DSEB1 and DSEB2, which
# their batches route (their DSEB3 crosses the router's limit only from 55 and
# 110 images, a map of B·h·N²·4 bytes); their Nonlocal sites are Synapse's.
# The Nonlocal sites of a ResNet-50/101/152 CENet (tagged ``resnet50``: dec1 at
# 56² with C = 256, dec2 at 28² with C = 512) take K2 and K4's wide designs;
# dec1 is routed at every batch, dec2 from 14 images (the 32-slice chunk).
DIFF_SITES = [("DSEB1", 8, 3136, 8, 16), ("DSEB2", 8, 784, 16, 32), ("DSEB3", 16, 196, 20, 40),
              ("acdc DSEB1", 4, 3136, 16, 32), ("acdc DSEB2", 4, 784, 32, 64),
              ("skin DSEB1", 2, 3136, 32, 64), ("skin DSEB2", 2, 784, 64, 128)]
ATTN_SITES = [("dec1", 1, 3136, 64, 64), ("dec2", 1, 784, 128, 128),
              ("resnet50 dec1", 1, 3136, 256, 256), ("resnet50 dec2", 1, 784, 512, 512)]
# routed at the training batch of 8
TRAIN_SITES = ("DSEB1", "DSEB2", "dec1", "acdc DSEB1", "acdc DSEB2", "skin DSEB1", "skin DSEB2", "resnet50 dec1")
# sites whose rows also carry the device time and the backend SDPA picked
DEVICE_TIMED = ("diff_attention_interleaved_fwd", "diff_attention_interleaved_bwd")


def preset_of(site) -> str:
    """The preset whose path holds ``site``: the tag before its name, else synapse."""
    return site.split()[0] if " " in site else "synapse"


# (site, kernel, h, n, d, dv) for phase 2 and phase 2b: K1 and K3 at every
# preset's sites, the split route's kernels at Synapse's, as their paths run them
SITES = ([(s, "diff_attention_interleaved_fwd", *dims) for s, *dims in DIFF_SITES]
         + [(s, "attention_fwd", *dims) for s, *dims in ATTN_SITES]
         + [(s, "diff_attention_fwd", *dims) for s, *dims in DIFF_SITES if preset_of(s) == "synapse"])
BWD_SITES = ([(s, "diff_attention_interleaved_bwd", *dims) for s, *dims in DIFF_SITES]
             + [(s, "attention_bwd", *dims) for s, *dims in ATTN_SITES]
             + [(s, k, *dims) for k in ("diff_attention_bwd", "diff_attention_bwd_split")
                for s, *dims in DIFF_SITES if s in TRAIN_SITES and preset_of(s) == "synapse"]
             + [(s, "attention_bwd_fused", *dims) for s, *dims in ATTN_SITES
                if s in TRAIN_SITES and preset_of(s) == "synapse"])  # K8 takes d, dv <= 128
PALLAS = "cenet_tpu/ops/pallas_attention.py"
# ``path``: the run whose launch counts the kernels line reports
KERNELS = {
    "diff_attention_interleaved_fwd": dict(
        k="K1", source="cenet_tpu_torch/csrc/diff_attention_fwd.cu", replaces=f"{PALLAS}:826 (_diff_fwd_pair_impl)",
        path="volume"),
    "attention_fwd": dict(
        k="K2", source="cenet_tpu_torch/csrc/attention_fwd.cu", replaces=f"{PALLAS}:90 (_pallas_attention_fwd_impl)",
        path="volume"),
    "diff_attention_fwd": dict(
        k="K5", source="cenet_tpu_torch/csrc/diff_attention_split_fwd.cu", replaces=f"{PALLAS}:360 (_diff_fwd_impl)",
        path="volume-split"),
}
# backward kernels and the forward kernel each differentiates
BWD_KERNELS = {
    "diff_attention_interleaved_bwd": dict(
        k="K3", source="cenet_tpu_torch/csrc/diff_attention_bwd.cu", fwd="diff_attention_interleaved_fwd",
        replaces=f"{PALLAS}:865 (_diff_bwd_pair_impl)", path="train"),
    "attention_bwd": dict(
        k="K4", source="cenet_tpu_torch/csrc/attention_bwd.cu", fwd="attention_fwd",
        replaces=f"{PALLAS}:261 (_pallas_attention_bwd_impl)", path="train"),
    "diff_attention_bwd": dict(
        k="K6", source="cenet_tpu_torch/csrc/diff_attention_split_bwd.cu", fwd="diff_attention_fwd",
        replaces=f"{PALLAS}:545 (_diff_bwd_onekernel_impl)", path="train-split"),
    "diff_attention_bwd_split": dict(
        k="K7", source="cenet_tpu_torch/csrc/diff_attention_split_bwd_two_kernel.cu", fwd="diff_attention_fwd",
        replaces=f"{PALLAS}:609 (_diff_bwd_impl)", path="train-split, K7 and K8"),
    "attention_bwd_fused": dict(
        k="K8", source="cenet_tpu_torch/csrc/attention_bwd_fused.cu", fwd="attention_fwd",
        replaces=f"{PALLAS}:212 (_pallas_attention_bwd_fused_impl)", path="train-split, K7 and K8"),
}
SPLIT_BWD = ("diff_attention_bwd", "diff_attention_bwd_split")
# backwards that write each gradient element from one block (K6 and K8 sum with atomics)
NO_ATOMICS_BWD = ("diff_attention_interleaved_bwd", "attention_bwd", "diff_attention_bwd_split")
# the gradients an atomic backward still writes from one block: K8's dk and dv,
# K6's dq (and dλ, one sum over the δ₂ its blocks write)
REPEAT_EXACT = {"attention_bwd_fused": ("dk", "dv"), "diff_attention_bwd": ("dq1", "dq2", "dlam")}
DIFF_BWD = ("diff_attention_interleaved_bwd", *SPLIT_BWD)  # these also give dλ
# launches per 32-slice chunk on each route (every kernel not listed: none)
VOLUME_PER_CHUNK = {"interleaved": {"diff_attention_interleaved_fwd": 3, "attention_fwd": 2},
                    "split": {"diff_attention_fwd": 3, "attention_fwd": 2}}
# launches per training step at B=8 (DSEB1, DSEB2 and dec1 are routed; DSEB3
# and dec2 only from B=14), and at B=2 in phase 3b, where the same three are
TRAIN_PER_STEP = {
    "interleaved": {"diff_attention_interleaved_fwd": 2, "attention_fwd": 1,
                    "diff_attention_interleaved_bwd": 2, "attention_bwd": 1},
    "split": {"diff_attention_fwd": 2, "attention_fwd": 1, "diff_attention_bwd": 2, "attention_bwd": 1},
    "split, K7 and K8": {"diff_attention_fwd": 2, "attention_fwd": 1, "diff_attention_bwd_split": 2,
                         "attention_bwd_fused": 1},
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def check_launches(launched, per_unit, units, where):
    """Every kernel launched exactly ``per_unit[name] * units`` times (0 if not listed)."""
    want = {name: per_unit.get(name, 0) * units for name in launched}
    check(launched == want, f"{where}: launches {launched}, expected {want}")


@contextlib.contextmanager
def split_route(swap_backwards=False):
    """While open, the DSEB sites take the split-group route: the model's
    ``router.diff_attention_interleaved`` is rebound to ``router.diff_attention_split``,
    whose ``diff_attention_core`` reaches K5 (and K6 under autograd) above the
    size limit. With ``swap_backwards``, ``DiffAttentionFn`` and ``AttentionFn``
    find K7 and K8 in place of K6 and K4. The package itself has no switch."""
    saved = router.diff_attention_interleaved, K.diff_attention_bwd, K.attention_bwd
    router.diff_attention_interleaved = router.diff_attention_split
    if swap_backwards:
        K.diff_attention_bwd, K.attention_bwd = K.diff_attention_bwd_split, K.attention_bwd_fused
    try:
        yield
    finally:
        router.diff_attention_interleaved, K.diff_attention_bwd, K.attention_bwd = saved


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernels(fn, ok, tries: int = 3):
    """The CUDA kernel events (``torch.profiler``) of one run of ``fn``, profiled
    again, up to ``tries`` times, while ``ok(events)`` is false: a session now
    and then loses kernel records while it keeps their launches (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ok(kernels):
            break
    return kernels


def split_args(args):
    """The split kernel's arguments (q1, k1, q2, k2, v, λ) for the interleaved
    kernel's (q, k, v, λ): the even and odd head views, read in place."""
    q, k, v, lam = args
    return q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2], v, lam


def site_inputs(kernel, b, h, n, d, dv, dtype, gen):
    """Inputs laid out as the model hands them over: the diff-attention q/k/v are
    transposed views of (B, N, heads, d) projections (for the split kernel, their
    head views); q is pre-scaled."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    if kernel in ("diff_attention_interleaved_fwd", "diff_attention_fwd"):
        q = (rnd(b, n, 2 * h, d) * d**-0.5).transpose(1, 2)
        args = q, rnd(b, n, 2 * h, d).transpose(1, 2), rnd(b, n, h, dv).transpose(1, 2), torch.tensor(0.2, device=DEV)
        return args if kernel == "diff_attention_interleaved_fwd" else split_args(args)
    return rnd(b, h, n, d) * d**-0.5, rnd(b, h, n, d), rnd(b, h, n, dv)


def kernel_fn(kernel):
    return getattr(K, kernel)


def plain_fn(kernel):
    return getattr(K, kernel + "_plain")


def v_index(kernel):
    """Where v sits among the forward kernel's arguments."""
    return 4 if kernel == "diff_attention_fwd" else 2


def library_fn(kernel, args):
    """One PyTorch library computation of the same function (timed as a yardstick only)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kernel in ("diff_attention_interleaved_fwd", "diff_attention_fwd"):
        q1, k1, q2, k2, v, lam = split_args(args) if kernel == "diff_attention_interleaved_fwd" else args
        return lambda: sdpa(q1, k1, v, scale=1.0) - lam * sdpa(q2, k2, v, scale=1.0)
    q, k, v = args
    return lambda: sdpa(q, k, v, scale=1.0)


def sdpa_backend(fn) -> str:
    """The backend SDPA takes for ``fn``'s calls (of it, and of its backward
    where ``fn`` runs the forward too):
    the first in PyTorch's priority order (``torch._C._get_sdp_priority_order``)
    that runs them when it is the only one enabled (``sdpa_kernel``), the
    check SDPA makes when it picks one. ("flash", "efficient", "cudnn" or
    "math".) No profiler: its sessions lose kernel records late in this run."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = {SDPBackend.FLASH_ATTENTION: "flash", SDPBackend.EFFICIENT_ATTENTION: "efficient",
             SDPBackend.CUDNN_ATTENTION: "cudnn", SDPBackend.MATH: "math"}
    enabled = {SDPBackend.FLASH_ATTENTION: torch.backends.cuda.flash_sdp_enabled(),
               SDPBackend.EFFICIENT_ATTENTION: torch.backends.cuda.mem_efficient_sdp_enabled(),
               SDPBackend.CUDNN_ATTENTION: torch.backends.cuda.cudnn_sdp_enabled(),
               SDPBackend.MATH: torch.backends.cuda.math_sdp_enabled()}
    by_value = {int(b): b for b in names}
    for value in torch._C._get_sdp_priority_order():
        backend = by_value.get(int(value))
        if backend is None or not enabled[backend]:
            continue
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fn()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        return names[backend]
    return "none"


def wide_site(kernel, site) -> bool:
    """A site that K2 or K4 take on their wide designs (d or dv past 128)."""
    return kernel in ("attention_fwd", "attention_bwd") and preset_of(site) == "resnet50"


def bound(kernel, b, h, n, d, dv, itemsize):
    """(ms for the operations, ms for the bytes): FLOPs over the bf16 peak, and
    bytes (inputs read once, outputs written once) over the memory rate."""
    groups = 2 if kernel in ("diff_attention_interleaved_fwd", "diff_attention_fwd") else 1
    flops = b * h * (groups * 2 * n * n * d + 2 * n * n * dv)
    nbytes = itemsize * b * (groups * h * n * d * 2 + h * n * dv * 2) + 4 * b * h * n * groups
    return flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


def exp_count(kernel, b, h, n):
    """The least number of exponentials of an attention kernel at a site with
    N = M = n: one per logit and softmax group, forward or backward."""
    groups = 2 if kernel in ("diff_attention_interleaved_fwd", "diff_attention_fwd", *DIFF_BWD) else 1
    return groups * b * h * n * n


def sfu_rate():
    """Exponentials per second the card's special-function units can give: 16
    per SM per clock (CUDA C Programming Guide, arithmetic-instruction
    throughput, compute capability 9.0) at the maximum SM clock that
    ``nvidia-smi`` reports. Returns (rate, SM count, clock in MHz)."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6, sms, mhz


def bound_by(t_ops, t_bytes):
    return "operations" if t_ops >= t_bytes else "bytes"


def fwd_inputs(kernel, b, h, n, d, dv, dtype, gen):
    """``site_inputs`` and, for the split kernel, the interleaved inputs whose
    head views they are (else None), so that K5 can be held against K1."""
    if kernel == "diff_attention_fwd":
        inter = site_inputs("diff_attention_interleaved_fwd", b, h, n, d, dv, dtype, gen)
        return split_args(inter), inter
    return site_inputs(kernel, b, h, n, d, dv, dtype, gen), None


def pair_check(got, inter, lim, where):
    """K5's (o, LSEs) against K1's on the interleaved inputs its head views come
    from: the same kernel in each dtype, held to the twin's limits. Returns the
    readings."""
    pair = K.diff_attention_interleaved_fwd(*inter)
    e_o = amax(got[0].float() - pair[0].float())
    e_l = max(amax(g - p) for g, p in zip(got[1:], pair[1:]))
    check(e_o <= lim and e_l <= TOL_FP32, f"diff_attention_fwd against K1 at {where}: o {e_o} (limit {lim}), "
          f"lse {e_l} (limit {TOL_FP32})")
    return {"vs_k1_err_o": e_o, "vs_k1_err_lse": e_l}


def phase_kernels(exp_rate):
    """Kernel vs twin at batch 2 (fp32, bf16), then at a 32-slice chunk (bf16,
    held against the twin in slices of 2) with times, the bound and the least
    time of its exponentials at ``exp_rate`` per second; K5 also against K1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    sites = []
    for site, kernel, h, n, d, dv in SITES:
        row = {"site": site, "kernel": kernel}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args, inter = fwd_inputs(kernel, 2, h, n, d, dv, dtype, gen)
            got = kernel_fn(kernel)(*args)
            r = fwd_check(kernel, args, got, f"{site} {label}")
            if inter is not None:
                r.update(pair_check(got, inter, r["limit_o"], f"{site} {label}"))
            row.update({f"{label}_{k}": v for k, v in r.items()})
            if label == "bf16":
                errs[kernel] = max(errs[kernel], row["bf16_err_o"])
        args2 = site_inputs(kernel, 2, h, n, d, dv, torch.bfloat16, gen)
        row["plain_ms_b2"] = time_ms(lambda: plain_fn(kernel)(*args2), reps=3)
        args, inter = fwd_inputs(kernel, CHUNK, h, n, d, dv, torch.bfloat16, gen)
        got = kernel_fn(kernel)(*args)
        row.update({f"chunk_{k}": v for k, v in
                    in_slices(fwd_check, kernel, args, got, f"{site} bf16 chunk of {CHUNK}").items()})
        if inter is not None:
            row.update({f"chunk_{k}": v for k, v in
                        pair_check(got, inter, row["chunk_limit_o"], f"{site} bf16 chunk of {CHUNK}").items()})
        errs[kernel] = max(errs[kernel], row["chunk_err_o"])
        # no forward kernel sums across blocks: two runs give the same bits
        again = kernel_fn(kernel)(*args)
        row["repeat_bit_identical"] = all(torch.equal(a, b) for a, b in zip(got, again))
        check(row["repeat_bit_identical"], f"{kernel} at {site}: two runs on the same inputs differ")
        del got, inter, again
        row["ms"] = time_ms(lambda: kernel_fn(kernel)(*args))
        # the twin's N×N maps at B=32 do not fit at once: time it over the same
        # inputs in slices of 2
        row["plain_ms"] = time_ms(lambda: [plain_fn(kernel)(*piece(args, i)) for i in range(0, CHUNK, 2)], reps=1)
        row["library_ms"] = time_ms(library_fn(kernel, args))
        row["ops_ms"], row["bytes_ms"] = bound(kernel, CHUNK, h, n, d, dv, 2)
        row["bound_ms"], row["bound_by"] = max(row["ops_ms"], row["bytes_ms"]), bound_by(row["ops_ms"], row["bytes_ms"])
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        if kernel in DEVICE_TIMED or wide_site(kernel, site):
            # device time: a CUDA graph of calls on copies of the inputs that pass twice the L2
            row["device_ms"] = graph_ms(kernel_fn(kernel), rotated(args))
            row["device_roofline_share"] = row["bound_ms"] / row["device_ms"]
        if wide_site(kernel, site):
            row["library_backend"] = sdpa_backend(library_fn(kernel, args))
            row["library_device_ms"] = graph_ms(lambda *a: library_fn(kernel, a)(), rotated(args))
            row["device_loss_factor"] = row["device_ms"] / row["library_device_ms"]
        row["exp_ms"] = exp_count(kernel, CHUNK, h, n) / exp_rate * 1e3
        del args, args2
        torch.cuda.empty_cache()
        emit({"phase": "kernels", **row})
        sites.append(row)
    K.reset_launches()
    return sites, errs


SMALL_LIMIT_MB = (8, 16, 32, 64)


def phase_small_limit(d=64):
    """Where plain math and K2 cross on the card: ``router.plain_attention``
    against K2 in bf16 at dec1's head dims (d = dv = 64, one head), at maps of
    8–64 MB (B·N·M·4 bytes, the router's measure) for one slice and for a
    training batch. Measured only: ``router._SMALL_LIMIT`` stays 32 MB, so that
    both packages route the same sites."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    rows = []
    for b in (1, TRAIN_B):
        for mb in SMALL_LIMIT_MB:
            n = round((mb * 2**20 / 4 / b) ** 0.5)
            q, k, v = site_inputs("attention_fwd", b, 1, n, d, d, torch.bfloat16, gen)
            rows.append({"batch": b, "n": n, "map_mb": b * n * n * 4 / 2**20,
                         "plain_ms": time_ms(lambda: router.plain_attention(q, k, v), reps=10),
                         "kernel_ms": time_ms(lambda: K.attention_fwd(q, k, v), reps=10)})
    faster = {b: min((r["map_mb"] for r in rows if r["batch"] == b and r["kernel_ms"] < r["plain_ms"]), default=None)
              for b in (1, TRAIN_B)}
    emit({"phase": "small_limit", "limit_mb": router._SMALL_LIMIT / 2**20, "rows": rows,
          "kernel_faster_from_map_mb": faster})
    K.reset_launches()


TOL_FP32_NORM = 1e-5  # fp32 backward, ‖grad − want‖ / ‖want‖


def grad_limits(dtype, want, want_r):
    """Limits on dq, dk, dv as (max |grad − want|, ‖grad − want‖ / ‖want‖).
    ``want``: the fp32 twin on the (rounded) inputs. fp32: only the order of
    summation (and the fast exponential's last bits) differs, so 1e-4 of
    max |want| and 1e-5 in norm. bf16: two bf16 half-ulps of max |want| (rounding
    the gradient, and ds or p values that kernel and twin round to different
    sides), plus the twin's own cost of rounding ds and p (or w) to bf16 before
    the products (``want_r``, the twin with those roundings); in norm the same,
    2·2^-8 plus the rounding cost measured in norm. The max-abs limit scales
    with the largest element; the norm limit holds the typical one."""
    if dtype == torch.float32:
        return [(TOL_FP32 * amax(w), TOL_FP32_NORM) for w in want]
    return [(2 * BF16_REL * amax(w) + amax(r.float() - w), 2 * BF16_REL + rel_norm(r, w)) for w, r in zip(want, want_r)]


def bwd_call_args(kernel, b, h, n, d, dv, dtype, gen):
    """The forward inputs at a site as the model hands them over, and the
    backward wrapper's arguments: those inputs, the forward's fp32 LSE (and o in
    the input dtype for the attention kernels) from the fp32 twin (in slices of
    2), and a strided dO."""
    fwd = BWD_KERNELS[kernel]["fwd"]
    args = site_inputs(fwd, b, h, n, d, dv, dtype, gen)
    do = torch.randn(b, n, h, dv, generator=gen, device=DEV).to(dtype).transpose(1, 2)
    fw = [torch.cat(parts) for parts in
          zip(*[plain_fn(fwd)(*[a.float() for a in piece(args, i)]) for i in range(0, b, 2)])]
    if kernel in DIFF_BWD:
        return args, (*args, fw[1], fw[2], do)
    return args, (*args, fw[0].to(dtype), fw[1], do)


def bwd_kernel_fn(kernel):
    return getattr(K, kernel)


def bwd_plain_fn(kernel):
    """The twin: K6 and K7 share one, as K4 and K8 do."""
    if kernel in SPLIT_BWD:
        return K.diff_attention_bwd_plain
    return K.diff_attention_interleaved_bwd_plain if kernel in DIFF_BWD else K.attention_bwd_plain


def grad_names(kernel):
    return ("dq1", "dk1", "dq2", "dk2", "dv") if kernel in SPLIT_BWD else ("dq", "dk", "dv")


def bwd_refs(kernel, call):
    """(want, want_r): the twin on fp32 copies of the inputs, and per gradient the
    twin that rounds ds (dq: to k's dtype, dk: to q's) or p/w (dv: to dO's dtype)
    as the kernel does but keeps the gradient itself in fp32."""
    plain = bwd_plain_fn(kernel)
    if kernel in SPLIT_BWD:
        q1, k1, q2, k2, v, lam, l1, l2, do = call
        f = [t.float() for t in (q1, k1, q2, k2, v)]
        want = plain(*f, lam, l1, l2, do.float())
        r_dq = plain(f[0], k1, f[2], k2, f[4], lam, l1, l2, do)
        r_dk = plain(q1, f[1], q2, f[3], f[4], lam, l1, l2, do)
        r_dv = plain(*f, lam, l1, l2, do)
        return want, (r_dq[0], r_dk[1], r_dq[2], r_dk[3], r_dv[4])
    if kernel in DIFF_BWD:
        q, k, v, lam, l1, l2, do = call
        fq, fk, fv, fdo = q.float(), k.float(), v.float(), do.float()
        want = plain(fq, fk, fv, lam, l1, l2, fdo)
        want_r = (plain(fq, k, fv, lam, l1, l2, do)[0], plain(q, fk, fv, lam, l1, l2, do)[1],
                  plain(fq, fk, fv, lam, l1, l2, do)[2])
        return want, want_r
    q, k, v, o, lse, do = call
    fq, fk, fv, fo, fdo = q.float(), k.float(), v.float(), o.float(), do.float()
    want = plain(fq, fk, fv, fo, lse, fdo)
    want_r = (plain(fq, k, fv, o, lse, do)[0], plain(q, fk, fv, o, lse, do)[1], plain(fq, fk, fv, o, lse, do)[2])
    return want, want_r


def bwd_check(kernel, call, got, where):
    """Hold a backward kernel's gradients (``got``, dλ left out) against the twin
    on the same inputs, in max-abs and in norm (``grad_limits``); raises past a
    limit. Returns the readings, with the twin's dλ for the diff kernels."""
    dtype = call[0].dtype
    want, want_r = bwd_refs(kernel, call)
    names = grad_names(kernel)
    out = {}
    for name, g, w, r, (lim, nlim) in zip(names, got, want, want_r, grad_limits(dtype, want[:len(names)], want_r)):
        e, ne = amax(g.float() - w), rel_norm(g, w)
        out.update({f"{name}_err": e, f"{name}_limit": lim, f"{name}_share": e / lim, f"{name}_norm_err": ne,
                    f"{name}_norm_limit": nlim, f"{name}_norm_share": ne / nlim, f"{name}_max_abs": amax(w)})
        if dtype == torch.bfloat16:
            out[f"{name}_round_term"], out[f"{name}_norm_round_term"] = amax(r.float() - w), rel_norm(r, w)
        check(g.dtype == dtype and e <= lim and ne <= nlim,
              f"{kernel} at {where}: {name} err {e} (limit {lim}), norm err {ne} (limit {nlim})")
    if kernel in DIFF_BWD:
        out["dlam_want"] = float(want[len(names)])
    return out


def dlam_check(kernel, got, want, where):
    """dλ is fp32 in both dtypes: one sum over the per-row δ₂ in another order,
    so 1e-4 of max(1, |dλ|). Returns the error."""
    e, lim = abs(float(got) - want), TOL_FP32 * max(1.0, abs(want))
    check(e <= lim, f"{kernel} at {where}: dlam err {e} (limit {lim})")
    return e


def bwd_library_fn(kernel, call):
    """The backward of ``scaled_dot_product_attention`` through autograd on the
    same inputs and dO (for the diff kernels, of the two-call composition
    o₁ − λo₂); a yardstick the port never calls."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    do = call[-1]
    if kernel in SPLIT_BWD:
        leaves = q1, k1, q2, k2, v = [t.detach().requires_grad_() for t in call[:5]]
        o = sdpa(q1, k1, v, scale=1.0) - call[5] * sdpa(q2, k2, v, scale=1.0)
    else:
        leaves = q, k, v = [t.detach().requires_grad_() for t in call[:3]]
        if kernel in DIFF_BWD:
            o = sdpa(q[:, 0::2], k[:, 0::2], v, scale=1.0) - call[3] * sdpa(q[:, 1::2], k[:, 1::2], v, scale=1.0)
        else:
            o = sdpa(q, k, v, scale=1.0)
    return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)


def bwd_library_device_ms(call):
    """Device time of SDPA's backward on K4's inputs (``call``): a graph of its
    forward and backward less a graph of its forward (``graph_ms``; a backward
    alone cannot be captured apart from the forward that records it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do = call[0], call[1], call[2], call[-1]

    def both(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(sdpa(*leaves, scale=1.0), leaves, do)

    return (graph_ms(both, rotated((q, k, v, do)))
            - graph_ms(lambda q, k, v: sdpa(q, k, v, scale=1.0), rotated((q, k, v))))


def bwd_bound(kernel, b, h, n, d, dv, itemsize):
    """(ms for the operations, ms for the bytes) of the least backward work:
    FLOPs 2·N·M·(6d + 2dv) per head pair for the diff kernels (s₁, s₂, G, dq₁₂,
    dk₁₂, dv), 2·N·M·(3d + 2dv) per head for attention (s, dP, dq, dk, dv); bytes
    of q, k, v, dO (and o, which Δ needs) and the LSEs read once, dq, dk, dv
    written once."""
    if kernel in DIFF_BWD:
        flops = b * h * 2 * n * n * (6 * d + 2 * dv)
        nbytes = itemsize * b * (4 * 2 * h * n * d + 3 * h * n * dv) + 4 * b * h * n * 2
    else:
        flops = b * h * 2 * n * n * (3 * d + 2 * dv)
        nbytes = itemsize * b * h * (4 * n * d + 4 * n * dv) + 4 * b * h * n
    return flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


def vs_k7_check(kernel, call, got, where):
    """K6's gradients (``got``) against K7's on the same inputs, under the limits
    that ``grad_limits`` sets against the twin there, in max-abs and in norm:
    the two designs share the twin and its rounding points. Returns the
    readings."""
    want, want_r = bwd_refs(kernel, call)
    k7 = K.diff_attention_bwd_split(*call)
    out = {}
    for name, g, w, (lim, nlim) in zip(grad_names(kernel), got, k7, grad_limits(call[0].dtype, want[:5], want_r)):
        e, ne = amax(g.float() - w.float()), rel_norm(g, w)
        out.update({f"vs_k7_{name}_err": e, f"vs_k7_{name}_share": e / lim, f"vs_k7_{name}_norm_share": ne / nlim})
        check(e <= lim and ne <= nlim,
              f"{kernel} against K7 at {where}: {name} err {e} (limit {lim}), norm err {ne} (limit {nlim})")
    return out


def bwd_site_check(kernel, call, where):
    """Run a backward kernel on ``call`` and hold it against its twin (in slices
    of 2), dλ included for the diff kernels; K6 also against K7. Returns the
    readings."""
    got = bwd_kernel_fn(kernel)(*call)
    n = len(grad_names(kernel))
    r = in_slices(bwd_check, kernel, call, got[:n], where)
    if kernel in DIFF_BWD:
        r["dlam_err"] = dlam_check(kernel, got[n], r["dlam_want"], where)
    if kernel == "diff_attention_bwd":
        r.update(in_slices(vs_k7_check, kernel, call, got[:n], where))
        r["vs_k7_dlam_err"] = dlam_check(kernel, got[n], float(K.diff_attention_bwd_split(*call)[n]),
                                         f"{where}, against K7")
    return r


def phase_bwd_kernels(exp_rate):
    """Backward kernel vs twin at batch 2 (fp32, bf16) at its sites; then, at the
    sites the training batch of 8 routes, the forward and backward kernels at
    that batch in fp32 and bf16, held against the twins in slices of 2, and the
    backward timed in bf16 beside its bound and the least time of its
    exponentials at ``exp_rate`` per second."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {k: 0.0 for k in BWD_KERNELS}
    fwd_errs = {k: 0.0 for k in KERNELS}
    fwd_done = set()  # (forward kernel, site) held at the training batch already
    sites = []
    for site, kernel, h, n, d, dv in BWD_SITES:
        fwd = BWD_KERNELS[kernel]["fwd"]
        row = {"site": site, "kernel": kernel}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            _, call = bwd_call_args(kernel, 2, h, n, d, dv, dtype, gen)
            r = bwd_site_check(kernel, call, f"{site} {label}")
            row.update({f"{label}_{k}": v for k, v in r.items()})
            if label == "bf16":
                errs[kernel] = max(errs[kernel], *(r[f"{g}_err"] for g in grad_names(kernel)))
            del call
        torch.cuda.empty_cache()
        if site in TRAIN_SITES:
            for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                where, key = f"{site} {label} batch {TRAIN_B}", f"b{TRAIN_B}_{label}"
                args, call = bwd_call_args(kernel, TRAIN_B, h, n, d, dv, dtype, gen)
                if (fwd, site) not in fwd_done:
                    got = kernel_fn(fwd)(*args)
                    row.update({f"{key}_fwd_{k}": v for k, v in in_slices(fwd_check, fwd, args, got, where).items()})
                    del got
                row.update({f"{key}_{k}": v for k, v in bwd_site_check(kernel, call, where).items()})
            if (fwd, site) not in fwd_done:
                fwd_errs[fwd] = max(fwd_errs[fwd], row[f"b{TRAIN_B}_bf16_fwd_err_o"])
                fwd_done.add((fwd, site))
            errs[kernel] = max(errs[kernel], *(row[f"b{TRAIN_B}_bf16_{g}_err"] for g in grad_names(kernel)))
            # repeat runs on the same inputs: bit-identical unless the kernel sums with atomics
            first, again = bwd_kernel_fn(kernel)(*call), bwd_kernel_fn(kernel)(*call)
            row["repeat_bit_identical"] = {g: bool(torch.equal(a, b))
                                           for g, a, b in zip((*grad_names(kernel), "dlam"), first, again)}
            check(kernel not in NO_ATOMICS_BWD or all(row["repeat_bit_identical"].values()),
                  f"{kernel} at {site}: two runs on the same inputs differ: {row['repeat_bit_identical']}")
            if kernel in REPEAT_EXACT:
                exact = REPEAT_EXACT[kernel]
                check(all(row["repeat_bit_identical"][g] for g in exact),
                      f"{kernel} at {site}: {exact} differ between two runs: {row['repeat_bit_identical']}")
                # the atomically summed gradients of the repeat run: within the twin's limits too
                again_r = in_slices(bwd_check, kernel, call, again[:len(grad_names(kernel))], f"{where} (repeat)")
                row.update({f"repeat_{k}": v for k, v in again_r.items()})
            del first, again
            # times on the bf16 inputs of the training batch
            row["ms"] = time_ms(lambda: bwd_kernel_fn(kernel)(*call))
            # the twin's maps at B=8 are large: time it over the same inputs in slices of 2
            row["plain_ms"] = time_ms(lambda: [bwd_plain_fn(kernel)(*piece(call, i)) for i in range(0, TRAIN_B, 2)],
                                      reps=1)
            row["library_ms"] = time_ms(bwd_library_fn(kernel, call))
            row["ops_ms"], row["bytes_ms"] = bwd_bound(kernel, TRAIN_B, h, n, d, dv, 2)
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            row["bound_by"] = bound_by(row["ops_ms"], row["bytes_ms"])
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            if kernel in DEVICE_TIMED or wide_site(kernel, site):
                row["device_ms"] = graph_ms(bwd_kernel_fn(kernel), rotated(call))
                row["device_roofline_share"] = row["bound_ms"] / row["device_ms"]
            if wide_site(kernel, site):
                # the forward that builds the graph picks the backend: run both under the test
                row["library_backend"] = sdpa_backend(lambda: bwd_library_fn(kernel, call)())
                row["library_device_ms"] = bwd_library_device_ms(call)
                row["device_loss_factor"] = row["device_ms"] / row["library_device_ms"]
            row["exp_ms"] = exp_count(kernel, TRAIN_B, h, n) / exp_rate * 1e3
            del args, call
            torch.cuda.empty_cache()
        emit({"phase": "bwd_kernels", **row})
        sites.append(row)
    K.reset_launches()
    return sites, errs, fwd_errs


def phase_slice_parity():
    """Seeded CENet-b2 on 2 slices: card fp32 (kernels) vs CPU fp32 (twins), then bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_preset("synapse")
    model = build_model(cfg, device=DEV, seed=0)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 224, 224)).astype(np.float32))
    K.reset_launches()
    with torch.inference_mode():
        gpu32 = model(x.to(DEV)).float().cpu()
        launched = dict(K.LAUNCHES)
        cpu32 = cpu_model(x)
        gpu16 = model(x.to(DEV, torch.bfloat16)).float().cpu()
    diff = float((gpu32 - cpu32).abs().max())
    agree = float((gpu32.argmax(1) == cpu32.argmax(1)).float().mean())
    agree16 = float((gpu16.argmax(1) == gpu32.argmax(1)).float().mean())
    emit({"phase": "slice_parity", "max_abs_logit_diff_fp32": diff, "argmax_agree_fp32": agree,
          "argmax_agree_bf16_vs_fp32": agree16, "launches_fp32_forward": launched})
    check(all(launched[k] > 0 for k in VOLUME_PER_CHUNK["interleaved"]), f"the fp32 forward launched no kernel: {launched}")
    check(diff <= 1e-3 and agree >= 0.999, f"slice parity: max abs {diff}, argmax agreement {agree}")
    del model, cpu_model
    torch.cuda.empty_cache()


# Phase 3b, fp32 with TF32 off; every limit is a share of the gradient's max |·|.
# The fp32 step at this size departs from float64 by about 1e-3 of max on the
# CPU as on the card (rounding that the step's own arithmetic amplifies), and
# cuDNN's convolutions move the card's gradients by as much again; with cuDNN
# off the card agrees with the CPU far more closely. At batch 8 the kernels
# move the gradients by as much as another convolution algorithm does. Picked
# gradients (the DSEB1 diff attention behind K3 and its λ, the dec1 Nonlocal
# behind K4): (against float64, for card and CPU alike; card against CPU; at
# batch 8, kernels against twins), each about twice its reading on an H100
# (PERF.md, phase 3b). The dec1 limit at batch 8 was read again under the
# JAX package's initial weights (PR 14): the kernels move that gradient by
# 7.7e-5 of its max, less than cuDNN's other convolution algorithm moves it
# (1.05e-4), where the earlier weights gave about 2e-5.
PARITY_GRADS = {
    "decoder.skip_enhancer1.diffattn.q_proj.weight": (6e-3, 3e-3, 3e-4),
    "decoder.skip_enhancer1.diffattn.lambda_q1": (3.2e-2, 6e-3, 1.5e-3),
    "decoder.dec1.mca.denoising_module.conv_theta.weight": (2e-3, 1e-3, 1.6e-4),
}
TOL_LOSS = 1e-5  # the loss, absolute, against float64
TOL_MEDIAN_VS_F64 = 3e-3  # the median over all parameters, card or CPU against float64
TOL_KERNEL_REL = 1e-4  # batch 2, kernels against twins on one card: their order of summation
TOL_NATIVE_REL = 1e-4  # card with the kernels and native convolutions against the CPU
TOL_B8_MEDIAN = 1e-3  # the median over all parameters at batch 8, kernels against twins


def labelled_slices(seed, n, size):
    """``n`` normalised CT-like slices (B, 1, size, size) and their labels 0–8."""
    case = synthetic_case(seed, d=4 * n, h=size, w=size)
    mid = slice(n + n // 2, 2 * n + n // 2)
    image = (case["image"][mid] - 0.5) / 0.5  # the dataset's Normalize(0.5, 0.5)
    return torch.from_numpy(image[:, None].copy()), torch.from_numpy(case["label"][mid].astype(np.int32))


@contextlib.contextmanager
def float64_stays():
    """While open, ``Tensor.float()`` leaves float64 tensors in float64 (other
    dtypes still go to float32), so that a float64 run of the port keeps its
    fp32 islands (norm statistics, softmax, λ, the loss) in float64 too."""
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self if self.dtype == torch.float64 else to_float(self, *a, **kw)
    try:
        yield
    finally:
        torch.Tensor.float = to_float


def twins_on_card(trainer, x, y):
    """``loss_and_grads`` with every site under the router's limit, so that the
    card runs the twins' plain math instead of the kernels."""
    limit = router._SMALL_LIMIT
    router._SMALL_LIMIT = 1 << 62
    try:
        return trainer.loss_and_grads(x, y)
    finally:
        router._SMALL_LIMIT = limit


def rel_max(a, b) -> float:
    """max |a − b| as a share of max |b|."""
    return amax(a.cpu().double() - b.cpu().double()) / max(amax(b), 1e-30)


def summary(errs):
    """The picked gradients, the median and the largest of per-parameter errors."""
    top = sorted(errs.items(), key=lambda kv: kv[1], reverse=True)
    return {"picked": {n: errs[n] for n in PARITY_GRADS}, "median": float(np.median(list(errs.values()))),
            "above_1e-4": sum(e > 1e-4 for e in errs.values()), "top": top[:6]}


def parity_config():
    """The Synapse preset in fp32 with drop-path off, so that no side draws."""
    base = get_preset("synapse")
    return base.replace(model=dataclasses.replace(base.model, drop_path_rate=0.0),
                        train=dataclasses.replace(base.train, amp=False))


def phase_train_parity():
    """One fp32 forward/backward of a seeded CENet-b2 in train mode (drop-path
    off so that no side draws). At batch 2 on labelled 224² slices: the card
    with the kernels, the card with the twins, the card with the kernels and
    cuDNN off (native convolutions), the CPU in fp32 and, as the witness of
    all, the CPU in float64. Card and CPU are each held against the witness and
    against each other, the card with native convolutions against the CPU, and
    the kernels against the twins on the same card. At the training batch of 8:
    the card with the kernels against the card with the twins, beside the
    twins with native convolutions against the twins (what another
    convolution algorithm alone moves)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = parity_config()
    x, y = labelled_slices(7, 2, 224)
    card = Trainer(cfg, 1, device=DEV, model_seed=0)
    card.model.train()
    K.reset_launches()
    loss, grads = card.loss_and_grads(x.to(DEV), y.to(DEV))
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    plain_loss, plain_grads = twins_on_card(card, x.to(DEV), y.to(DEV))
    torch.backends.cudnn.enabled = False
    try:
        native_loss, native_grads = card.loss_and_grads(x.to(DEV), y.to(DEV))
    finally:
        torch.backends.cudnn.enabled = True
    cpu = Trainer(cfg, 1, device="cpu", model_seed=0)
    cpu.model.train()
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = cpu.loss_and_grads(x, y)
    cpu_s = time.perf_counter() - t0
    witness = Trainer(cfg, 1, device="cpu", model_seed=0)
    witness.model.double().train()
    witness.compute_dtype = torch.float64
    t0 = time.perf_counter()
    with float64_stays():
        w_loss, w_grads = witness.loss_and_grads(x, y)
    witness_s = time.perf_counter() - t0
    names = [n for n, _ in cpu.model.named_parameters()]
    # parameters whose gradient is zero by the model's structure (a bias right
    # before a train-mode BatchNorm): float64 leaves ~1e-17 of the largest
    # gradient there, fp32 ~1e-8, and a share of that max means nothing
    scale = {n: amax(w) for n, w in zip(names, w_grads) if w is not None}
    live = {n for n, s in scale.items() if s > 1e-10 * max(scale.values())}

    def rel_errs(gs, ws):
        return {n: rel_max(g, w) for n, g, w in zip(names, gs, ws) if n in live}

    runs = {"card_kernels": grads, "card_kernels_native_conv": native_grads, "cpu": cpu_grads}
    vs_f64 = {run: rel_errs(gs, w_grads) for run, gs in runs.items()}
    vs_cpu, own = rel_errs(grads, cpu_grads), rel_errs(grads, plain_grads)
    native_vs_cpu = rel_errs(native_grads, cpu_grads)

    losses = {"card_kernels": float(loss), "card_twins": float(plain_loss), "card_kernels_native_conv":
              float(native_loss), "cpu": float(cpu_loss), "float64": float(w_loss)}
    emit({"phase": "train_parity", "batch": 2, "losses": losses, "parameters": len(names),
          "compared": len(live),
          "grad_rel_err_vs_float64": {run: summary(e) for run, e in vs_f64.items()},
          "grad_rel_err_card_kernels_vs_cpu": summary(vs_cpu),
          "grad_rel_err_card_kernels_native_conv_vs_cpu": summary(native_vs_cpu),
          "grad_rel_err_kernels_vs_twins": summary(own),
          "cpu_s": cpu_s, "float64_s": witness_s, "launches_card": launched})
    check_launches(launched, TRAIN_PER_STEP["interleaved"], 1, "train parity")
    for run, value in losses.items():
        check(abs(value - float(w_loss)) <= TOL_LOSS, f"train parity: {run} loss {value} vs float64 {float(w_loss)}")
    for run in ("card_kernels", "cpu"):
        median = float(np.median(list(vs_f64[run].values())))
        check(median <= TOL_MEDIAN_VS_F64, f"train parity: {run} gradients off float64 by a median {median} of max")
    for n, (lim_f64, lim_cpu, _) in PARITY_GRADS.items():
        check(own[n] <= TOL_KERNEL_REL, f"train parity: the kernels move the gradient of {n} by {own[n]} of its max")
        for run in ("card_kernels", "cpu"):
            check(vs_f64[run][n] <= lim_f64,
                  f"train parity: {run} gradient of {n} off float64 by {vs_f64[run][n]} of its max (limit {lim_f64})")
        check(vs_cpu[n] <= lim_cpu, f"train parity: gradient of {n} off the CPU's by {vs_cpu[n]} (limit {lim_cpu})")
        check(native_vs_cpu[n] <= TOL_NATIVE_REL,
              f"train parity: with native convolutions the gradient of {n} is off the CPU's by {native_vs_cpu[n]}")
    del cpu, witness, grads, plain_grads, native_grads, cpu_grads
    swapped_launches = phase_swapped_train_parity(card, x.to(DEV), y.to(DEV), float(w_loss), w_grads, names, live)
    del w_grads

    # the training batch: kernels against twins on the card
    x, y = labelled_slices(11, TRAIN_B, 224)
    K.reset_launches()
    _, grads = card.loss_and_grads(x.to(DEV), y.to(DEV))
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    _, plain_grads = twins_on_card(card, x.to(DEV), y.to(DEV))
    torch.backends.cudnn.enabled = False
    try:  # how far another convolution algorithm alone moves the same step
        _, native_grads = twins_on_card(card, x.to(DEV), y.to(DEV))
    finally:
        torch.backends.cudnn.enabled = True
    own, conv = rel_errs(grads, plain_grads), rel_errs(native_grads, plain_grads)
    emit({"phase": "train_parity", "batch": TRAIN_B, "grad_rel_err_kernels_vs_twins": summary(own),
          "grad_rel_err_twins_native_conv_vs_twins": summary(conv),
          "launches_card": launched, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check_launches(launched, TRAIN_PER_STEP["interleaved"], 1, f"train parity, batch {TRAIN_B}")
    median = float(np.median(list(own.values())))
    check(median <= TOL_B8_MEDIAN, f"train parity, batch {TRAIN_B}: the kernels move the gradients by a median {median}")
    for n, (_, _, lim) in PARITY_GRADS.items():
        check(own[n] <= lim,
              f"train parity, batch {TRAIN_B}: the kernels move the gradient of {n} by {own[n]} of its max (limit {lim})")
    del card, grads, plain_grads, native_grads
    torch.cuda.empty_cache()
    return live, swapped_launches


def phase_split_train_parity(live):
    """One fp32 train step at the training batch of 8 (TF32 off, drop-path off)
    on the split route against the interleaved route, from the same weights and
    batch: the loss within ``TOL_LOSS``, the gradients (over phase 3b's
    parameters) within phase 3b's batch-8 limits of kernels against twins (the
    two routes differ in fp32 summation order only: K6's dv sums P₁ᵀdO and
    P₂ᵀdO apart, and adds over query tiles with atomics). Then the same step
    with K7 and K8 in place of K6 and K4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = labelled_slices(11, TRAIN_B, 224)
    x, y = x.to(DEV), y.to(DEV)
    card = Trainer(parity_config(), 1, device=DEV, model_seed=0)
    card.model.train()
    loss, grads = card.loss_and_grads(x, y)
    names = [n for n, _ in card.model.named_parameters()]
    for route, swap in (("split", False), ("split, K7 and K8", True)):
        K.reset_launches()
        with split_route(swap_backwards=swap):
            s_loss, s_grads = card.loss_and_grads(x, y)
        torch.cuda.synchronize()
        launched = dict(K.LAUNCHES)
        errs = {n: rel_max(g, w) for n, g, w in zip(names, s_grads, grads) if n in live}
        emit({"phase": "split_train_parity", "route": route, "batch": TRAIN_B, "loss": float(s_loss),
              "loss_interleaved": float(loss), "grad_rel_err_vs_interleaved": summary(errs), "launches": launched})
        check_launches(launched, TRAIN_PER_STEP[route], 1, f"split train parity ({route})")
        check(abs(float(s_loss) - float(loss)) <= TOL_LOSS,
              f"split train parity ({route}): loss {float(s_loss)} vs interleaved {float(loss)}")
        median = float(np.median(list(errs.values())))
        check(median <= TOL_B8_MEDIAN, f"split train parity ({route}): gradients off by a median {median} of max")
        for n, (_, _, lim) in PARITY_GRADS.items():
            check(errs[n] <= lim, f"split train parity ({route}): gradient of {n} off by {errs[n]} (limit {lim})")
        del s_grads
    del card, grads
    torch.cuda.empty_cache()


def synthetic_case(seed, d=64, h=512, w=512):
    """A CT-like volume: eight ellipsoid organs (labels 1–8) on a noisy body."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.ogrid[:d, :h, :w]
    label = np.zeros((d, h, w), np.uint8)
    image = rng.normal(0.05, 0.03, (d, h, w)).astype(np.float32)
    for c in range(1, 9):
        cz, cy, cx = rng.uniform(0.2 * d, 0.8 * d), rng.uniform(0.25 * h, 0.75 * h), rng.uniform(0.25 * w, 0.75 * w)
        rz, ry, rx = rng.uniform(0.1 * d, 0.3 * d), rng.uniform(25, 70), rng.uniform(25, 70)
        inside = ((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        label[inside] = c
        image[inside] = 0.1 * c + 0.02 * rng.standard_normal(int(inside.sum())).astype(np.float32)
    return {"image": image, "label": label, "case_name": f"synthetic{seed}"}


def hu_case(seed):
    """``synthetic_case`` with integer, HU-like intensities (about -200 to 700),
    which a uint16 upload carries exactly (phase 4d's uint16 check only: the
    Synapse preset normalises its input as if it lay in [0, 1])."""
    case = synthetic_case(seed)
    case["image"] = (np.rint(case["image"] * 1000.0) - 200.0).astype(np.float32)
    return case


class InMemoryVolumes:
    """The ``volumes()`` of ``SynapseDataset``'s ``test_vol`` split over cases held
    in memory, for a machine without ``h5py`` to write the ``.npy.h5`` files."""

    def __init__(self, cases):
        self.cases = cases

    def volumes(self):
        return iter(self.cases)


class MetricMemo:
    """The volume module's ``calculate_metric_percase``, remembered by the
    bytes of its two masks: phase 4 computes every case's metrics through it,
    and phase 4d's CLI run over the same cases reads them back (a mask pair
    not seen before is computed and counted in ``misses``)."""

    def __init__(self):
        self.fn, self.seen, self.misses = VOL.calculate_metric_percase, {}, 0

    def __call__(self, pred, gt):
        key = (pred.shape, hashlib.sha1(np.packbits(pred)).digest(), hashlib.sha1(np.packbits(gt)).digest())
        if key not in self.seen:
            self.misses += 1
            self.seen[key] = self.fn(pred, gt)
        return self.seen[key]

    @contextlib.contextmanager
    def installed(self):
        VOL.calculate_metric_percase = self
        try:
            yield self
        finally:
            VOL.calculate_metric_percase = self.fn


def instrument(inf):
    """Timers around ``inf``'s chunk step, its host back-zoom and
    ``predict_volume``. The step's timer is a pair of CUDA events recorded on
    the compute stream as the host enters and leaves the step: its span holds
    the host's dispatch of the step (and a wait on the chunk's upload), so it
    reads host-bound time, not the device's (phase 5 reads that). The others
    are host clocks. ``read(rec)`` gives the per-chunk means and slices/s."""
    rec = {"events": [], "zoom_s": 0.0, "predict_s": 0.0, "slices": 0}
    labels_fn, back_zoom_fn, predict = inf._labels, inf._back_zoom_fn, inf.predict_volume

    def labels(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = labels_fn(*args)
        end.record()
        rec["events"].append((start, end))
        return out

    def timed_back_zoom_fn(h, w):
        fn = back_zoom_fn(h, w)

        def back_zoom(p):
            t0 = time.perf_counter()
            out = fn(p)
            rec["zoom_s"] += time.perf_counter() - t0
            return out

        return back_zoom

    def predict_volume(image):
        t0 = time.perf_counter()
        out = predict(image)
        rec["predict_s"] += time.perf_counter() - t0
        rec["slices"] += image.shape[0]
        return out

    inf._labels, inf._back_zoom_fn, inf.predict_volume = labels, timed_back_zoom_fn, predict_volume
    return rec


def read(rec):
    torch.cuda.synchronize()
    n = len(rec["events"])
    return {"slices_per_s": rec["slices"] / rec["predict_s"], "chunks": n,
            "wall_ms_per_chunk": rec["predict_s"] / n * 1e3,
            "step_event_ms_per_chunk": sum(s.elapsed_time(e) for s, e in rec["events"]) / n,
            "back_zoom_ms_per_chunk": rec["zoom_s"] / n * 1e3}


def phase_volume():
    """The main path: bf16 volume inference with metrics on two synthetic
    cases (intensities in [0, 1], as the Synapse preset's normalisation
    expects) with the seeded CENet-b2 of phase 4d's checkpoint. Returns the
    launch counts, and the cases with their labels, ``run_inference``'s
    result and the metrics it computed, which phase 4d's CLI run must
    reproduce."""
    cfg = get_preset("synapse")
    model = build_model(cfg, device=DEV, seed=0)
    inf = VolumeInferencer(make_predict_fn(model, torch.bfloat16),
                           VolumeInferenceConfig(img_size=224, chunk=CHUNK, num_classes=9), device=DEV)
    cases = [synthetic_case(1), synthetic_case(2)]
    inf.predict_volume(cases[0]["image"][:CHUNK])  # warm-up: cuDNN plans, matrices, kernel loads
    rec = instrument(inf)
    preds = {}
    K.reset_launches()
    t0 = time.perf_counter()
    with MetricMemo().installed() as memo:
        dice, hd95 = run_inference(inf, cases, save_hook=lambda case, pred: preds.update({case["case_name"]: pred}))
    run_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    timing = read(rec)
    chunks = sum(-(-c["image"].shape[0] // CHUNK) for c in cases)
    emit({"phase": "volume", "cases": len(cases), "slices": rec["slices"], **timing, "predict_s": rec["predict_s"],
          "metrics_s": run_s - rec["predict_s"], "mean_dice": dice, "mean_hd95": hd95,
          "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(np.isfinite(dice) and np.isfinite(hd95) and 0.0 <= dice <= 1.0, f"metrics {dice}, {hd95}")
    check(timing["chunks"] == chunks, f"volume: {timing['chunks']} chunk steps, expected {chunks}")
    check_launches(launches, VOLUME_PER_CHUNK["interleaved"], chunks, f"volume, {chunks} chunks")
    del model
    torch.cuda.empty_cache()
    return launches, {"cases": cases, "preds": preds, "result": {"mean_dice": dice, "mean_hd95": hd95},
                      "metrics": memo}


@contextlib.contextmanager
def twin_route():
    """While open, the DSEB sites take K1's fp32 twin in place of the kernel
    (the Pallas rounding points in fp32 torch, in slices of 2)."""
    def twin(q, k, v, lam, head_local=False, impl="pallas"):  # one process: the batch is the global one
        return torch.cat([K.diff_attention_interleaved_fwd_plain(*piece((q, k, v, lam), i))[0]
                          for i in range(0, q.shape[0], 2)])

    saved = router.diff_attention_interleaved
    router.diff_attention_interleaved = twin
    try:
        yield
    finally:
        router.diff_attention_interleaved = saved


def phase_split_volume():
    """The volume path on the split route against the interleaved route: one bf16
    32-slice chunk through ``make_predict_fn``, required equal to the bit
    (probabilities and argmax: K5 launches K1's kernel on the split head views,
    so the two routes are one computation), and how far the interleaved chunk
    lies from the same chunk with the DSEB sites through K1's twin (measured
    only: any other sound bf16 rounding of the DSEB outputs moves this chunk by
    about 2e-3, so no limit between 0 and that separates a sound run from a
    faulty one); then a synthetic 64-slice case through
    ``VolumeInferencer`` on each route in turns (interleaved, split, split,
    interleaved): labels agreeing on ≥ 99.9% of voxels, slices/s of each route,
    and the launch counts of one split run. Returns those counts."""
    model = build_model(get_preset("synapse"), device=DEV, seed=0)
    predict = make_predict_fn(model, torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(4)
    x = torch.randn(CHUNK, 1, 224, 224, generator=gen, device=DEV)
    inter = predict(x)
    with split_route():
        split = predict(x)
    diff, agree = amax(split - inter), float((split.argmax(1) == inter.argmax(1)).float().mean())
    with twin_route():
        twin = predict(x)
    twin_diff, twin_agree = amax(twin - inter), float((twin.argmax(1) == inter.argmax(1)).float().mean())
    inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=224, chunk=CHUNK, num_classes=9), device=DEV)
    image = synthetic_case(1)["image"]
    chunks = -(-image.shape[0] // CHUNK)
    inf.predict_volume(image[:CHUNK])  # warm-up of both routes
    with split_route():
        inf.predict_volume(image[:CHUNK])
    seconds = {"interleaved": [], "split": []}
    labels = {}
    for route in ("interleaved", "split", "split", "interleaved"):
        with split_route() if route == "split" else contextlib.nullcontext():
            K.reset_launches()
            t0 = time.perf_counter()
            labels[route] = inf.predict_volume(image)
            seconds[route].append(time.perf_counter() - t0)
            launched = dict(K.LAUNCHES)
        check_launches(launched, VOLUME_PER_CHUNK[route], chunks, f"split volume ({route} route)")
        if route == "split":
            split_launches = launched
    label_agree = float((labels["split"] == labels["interleaved"]).mean())
    emit({"phase": "split_volume", "chunk_max_abs_prob_diff": diff, "chunk_argmax_agree": agree,
          "chunk_max_abs_prob_diff_twin_route": twin_diff, "chunk_argmax_agree_twin_route": twin_agree,
          "case_label_agree": label_agree, "slices": int(image.shape[0]), "chunks": chunks,
          "slices_per_s": {r: [image.shape[0] / t for t in ts] for r, ts in seconds.items()},
          "launches_split": split_launches})
    check(diff == 0.0 and agree == 1.0,
          f"split volume: the split route's bf16 chunk differs from the interleaved one (max abs {diff}, argmax "
          f"agreement {agree}); K5 launches K1's kernel, so they must be equal to the bit (any other sound bf16 "
          f"rounding of the DSEB outputs moves this chunk by about 2e-3, the twin route here by {twin_diff})")
    check(label_agree >= 0.999, f"split volume: labels agree on {label_agree} of the case")
    del model
    torch.cuda.empty_cache()
    return split_launches


# The kernels whose dtype picks their design, by their symbols: the
# tensor-core designs that bf16 calls launch, K2's, K4's and K8's
# (csrc/attention_tc.cuh), K1's, K5's, K3's, K7's and K6's
# (csrc/diff_attention_tc.cuh; K7 runs K3's dq kernel and the dk/dv kernel
# whose last template argument, SPLIT_DV, is true; K6 its own one-launch
# kernel) and K12's forward (csrc/smallc_conv.cu); the CUDA-core instances of
# csrc/attention_{fwd,bwd}_common.cuh (the forward's first template argument is
# GROUPS, the backward's the dtype), GROUPS = 1 (K2, K4 and K8 in fp32) and
# GROUPS = 2 (K1, K3, K5 and K7 in fp32; K6's one-launch instance), and K12's
# CUDA-core forward (fp32 only, so never in a bf16 profile); K12's backward:
# dx on K12's tensor-core forward, dw on its own tensor-core kernel, and the
# CUDA-core backward (fp32; in bf16 only for a Cout outside 8, 16, 32, 64,
# none at the OutHead sites); K11's forward in both dtypes, by layout
# (dw3x3_cl_kernel channels-last, dw3x3_plane_kernel any other strides), its
# dw (dw3x3_dw_cl_kernel where x and g are both channels-last,
# dw3x3_dw_plane_kernel otherwise, counted by route in depthwise.DW_ROUTES;
# the ordered sum in the launch); K10's vectorised rotary (csrc/rotary.cu)
KERNEL_DESIGNS = {"fwd_tc": r"attention_fwd_tc_kernel<", "bwd_dq_tc": r"attention_bwd_dq_tc_kernel<",
                  "wide_wgmma": r"attention_(wide_wgmma|fwd_rows)_kernel<",
                  "bwd_dkv_tc": r"attention_bwd_dkv_tc_kernel<",
                  "bwd_fused_tc": r"attention_bwd_fused_tc_kernel<",
                  "fwd_cuda_core": r"attention_fwd_kernel<1,",
                  "bwd_cuda_core": r"attention_bwd_(dq|dkv)_kernel<[^,<>]+, 1,",
                  "diff_fwd_tc": r"diff_fwd_tc_kernel<", "diff_bwd_dq_tc": r"diff_bwd_dq_tc_kernel<",
                  "diff_bwd_dkv_tc": r"diff_bwd_dkv_tc_kernel<.*, false>",
                  "diff_bwd_dkv_split_tc": r"diff_bwd_dkv_tc_kernel<.*, true>",
                  "diff_bwd_one_tc": r"diff_bwd_one_tc_kernel<",
                  "diff_fwd_cuda_core": r"attention_fwd_kernel<2,",
                  "diff_bwd_cuda_core": r"attention_bwd_(dq_kernel<[^,<>]+, 2, \d+, false>|dkv_kernel<[^,<>]+, 2,)",
                  "diff_bwd_one_launch": r"attention_bwd_dq_kernel<[^,<>]+, 2, \d+, true>",
                  "conv_fwd_tc": r"conv_fwd_tc_kernel<",
                  "conv_fwd_cuda_core": r"conv_fwd_kernel<",
                  "conv_dw_tc": r"conv_dw_tc_kernel<",
                  "conv_bwd_cuda_core": r"conv_bwd_kernel<",
                  "depthwise_fwd_tiled": r"dw3x3_(cl|plane)_kernel<",
                  "depthwise_dw_tiled": r"dw3x3_dw_(cl|plane)_kernel<",
                  "rotary_vec": r"rotary_vec_kernel<"}
# the kernels one bf16 call of each such wrapper launches, by design
BF16_DESIGNS = {"attention_fwd": ("fwd_tc",), "attention_bwd": ("bwd_dq_tc", "bwd_dkv_tc"),
                "diff_attention_interleaved_fwd": ("diff_fwd_tc",),
                "diff_attention_interleaved_bwd": ("diff_bwd_dq_tc", "diff_bwd_dkv_tc"),
                "diff_attention_fwd": ("diff_fwd_tc",), "diff_attention_bwd": ("diff_bwd_one_tc",),
                "diff_attention_bwd_split": ("diff_bwd_dq_tc", "diff_bwd_dkv_split_tc"),
                "attention_bwd_fused": ("bwd_fused_tc",), "conv_small_c_fwd": ("conv_fwd_tc",),
                "conv_small_c_bwd": ("conv_fwd_tc", "conv_dw_tc"), "depthwise_fwd": ("depthwise_fwd_tiled",),
                "depthwise_dw": ("depthwise_dw_tiled",), "rotary": ("rotary_vec",)}


def kernel_designs(kernels):
    """Calls and device ms of the kernels of ``KERNEL_DESIGNS`` by design, from profiler events."""
    return {role: {"calls": sum(e.count for e in kernels if re.search(pat, e.key)),
                   "ms": sum(e.self_device_time_total for e in kernels if re.search(pat, e.key)) / 1e3}
            for role, pat in KERNEL_DESIGNS.items()}


def expected_designs(per_unit):
    """Calls of each design that the launch counts ``per_unit`` give in bf16."""
    want = collections.Counter()
    for name, n in per_unit.items():
        for role in BF16_DESIGNS.get(name, ()):
            want[role] += n
    return want


def check_designs(designs, per_unit, where):
    """Every design launched exactly as often as the bf16 launch counts
    ``per_unit`` say, and no other: in particular no CUDA-core instance of a
    kernel that bf16 sends to the tensor cores."""
    want = expected_designs(per_unit)
    got = {r: d["calls"] for r, d in designs.items()}
    check(all(got[r] == want[r] for r in KERNEL_DESIGNS),
          f"{where}: kernels by design {got}, expected {dict(want)} and no others")


def phase_profile(top: int = 12):
    """Where one chunk's forward spends the card's time: a bf16 forward of 32
    slices at 224², its wall time (CUDA events) and its device time by kernel
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model(get_preset("synapse"), device=DEV, seed=0)
    predict = make_predict_fn(model, torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn(CHUNK, 1, 224, 224, generator=gen, device=DEV)
    forward_ms = time_ms(lambda: predict(x), reps=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    designs = kernel_designs(kernels)
    emit({"phase": "profile", "forward_ms": forward_ms, "device_busy_ms": busy_ms, "kernel_names": len(kernels),
          "kernel_designs": designs,
          "top": [{"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                  for e in kernels[:top]]})
    check_designs(designs, VOLUME_PER_CHUNK["interleaved"], "bf16 chunk profile")
    del model
    torch.cuda.empty_cache()


def write_split(root, seed=5):
    """A synthetic case's 64 slices of 512² as Synapse ``.npz`` files with a ``train.txt``."""
    case = synthetic_case(seed)
    names = []
    for i, (image, label) in enumerate(zip(case["image"], case["label"])):
        names.append(f"{case['case_name']}_slice{i:03d}")
        np.savez(os.path.join(root, names[-1] + ".npz"), image=image, label=label)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return len(names)


def phase_train(root, warmup=3, steps=30):
    """The training path: ``SynapseDataset`` → ``Loader`` → ``Trainer.train_step``
    with the Synapse preset as it stands, on 64 slices written under ``root``
    (which phases 6b and 6g read again); returns the launch counts of the timed
    steps, the trainer, a device-resident batch, the img/s through the loader
    and the wait on it a step (ms)."""
    cfg = get_preset("synapse")
    n_slices = write_split(root)
    ds = SynapseDataset(root, root, "train", img_size=cfg.data.img_size)  # preloads every slice
    loader = Loader(len(ds), ds.get_train, cfg.train.batch_size, seed=cfg.train.seed,
                    num_threads=cfg.data.num_workers, put_fn=device_put_fn(DEV))
    trainer = Trainer(cfg, max_iterations=cfg.train.max_epochs * len(loader), iters_per_epoch=len(loader),
                      device=DEV, model_seed=0)

    def batches():
        epoch = 0
        while True:
            yield from loader.epoch(epoch)
            epoch += 1

    it = batches()
    losses, wait = [], 0.0
    try:
        for _ in range(warmup):  # cuDNN plans, kernel loads, optimizer state
            batch = next(it)
            losses.append(trainer.train_step(batch["image"], batch["label"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            tw = time.perf_counter()
            batch = next(it)
            wait += time.perf_counter() - tw
            losses.append(trainer.train_step(batch["image"], batch["label"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        it.close()  # ends the epoch's loader threads
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_values = torch.stack(losses).cpu().tolist()
    images, labels = batch["image"], batch["label"]
    step_ms = time_ms(lambda: trainer.train_step(images, labels), reps=10)
    emit({"phase": "train", "slices": n_slices, "batch": cfg.train.batch_size, "compute": "bf16",
          "loader_threads": cfg.data.num_workers, "opencv": augment.cv2 is not None,
          "warmup_steps": warmup, "steps": steps,
          "img_per_s": steps * cfg.train.batch_size / wall, "step_wall_ms": wall / steps * 1e3,
          # a step on a batch already on the card, by CUDA events: wall time of the
          # step with the host's dispatch in it, not the card's busy time (phase 7)
          "loader_wait_ms_per_step": wait / steps * 1e3, "resident_step_ms": step_ms,
          "resident_img_per_s": cfg.train.batch_size / step_ms * 1e3, "peak_mem_gb": peak_gb,
          "losses": loss_values, "launches": launches,
          "launches_per_step": {k: v / steps for k, v in launches.items()}})
    check(all(np.isfinite(loss_values)), f"a training loss is not finite: {loss_values}")
    check_launches(launches, TRAIN_PER_STEP["interleaved"], steps, f"train, {steps} steps")
    return launches, trainer, images, labels, steps * cfg.train.batch_size / wall, wait / steps * 1e3


def profile_step(trainer, images, labels, top=15):
    """``torch.profiler`` over one training step after one unprofiled step: the
    card's busy time, the attention kernels' calls and device ms by design, the device
    time of the autograd scatter of head-view gradients (``aten::slice_backward``),
    the top kernels, and the host side."""
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    scatter = [e for e in events if e.key == "aten::slice_backward"]
    # the host side: operators by their own CPU time (what the Python thread spends
    # issuing the step)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"step_wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "kernel_names": len(kernels),
            "kernel_launches": sum(e.count for e in kernels),
            "kernel_designs": kernel_designs(kernels),
            "slice_backward": {"calls": sum(e.count for e in scatter),
                               "device_ms": sum(e.device_time_total for e in scatter) / 1e3},
            "top": [{"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]],
            "host_ops": sum(e.count for e in host), "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "top_host": [{"name": e.key[:80], "calls": e.count, "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:top]]}


def phase_train_profile(trainer, images, labels):
    """Where one bf16 training step's device time goes (``torch.profiler``); K1
    to K4 run their tensor-core kernels."""
    prof = profile_step(trainer, images, labels)
    emit({"phase": "train_profile", **prof})
    check_designs(prof["kernel_designs"], TRAIN_PER_STEP["interleaved"], "bf16 train step profile")


def phase_split_train(trainer, images, labels, steps=10, swap_backwards=False):
    """Phase 6's bf16 trainer on its resident batch, on the split route: the
    step's ms over ``steps`` steps (CUDA events), their launch counts, and one
    profiled step (the attention kernels' device ms, the head-view gradient
    scatter) beside phase 7's, which must show every attention design exactly
    as the launch counts say: K5 on K1's tensor-core kernel and K6's
    tensor-core kernel and no CUDA-core instance of K6 (phase 7b), or with
    ``swap_backwards`` K7's and K8's tensor-core kernels and no CUDA-core
    instance of either (phase 7d). Returns the launch
    counts."""
    route = "split, K7 and K8" if swap_backwards else "split"
    with split_route(swap_backwards=swap_backwards):
        trainer.train_step(images, labels)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        K.reset_launches()
        start.record()
        for _ in range(steps):
            trainer.train_step(images, labels)
        end.record()
        torch.cuda.synchronize()
        launched = dict(K.LAUNCHES)
        prof = profile_step(trainer, images, labels)
    emit({"phase": "split_train", "route": route, "steps": steps,
          "resident_step_ms": start.elapsed_time(end) / steps, "launches": launched, "profile": prof})
    check_launches(launched, TRAIN_PER_STEP[route], steps, f"split train ({route}), {steps} steps")
    check_designs(prof["kernel_designs"], TRAIN_PER_STEP[route], f"split bf16 train step profile ({route})")
    return launched


# ---------------------------------------------------------------------------
# K9–K12: the kernels no configuration routes, swapped in at their own sites
# ---------------------------------------------------------------------------

# launches of the swapped ops per forward of CENet-b2: K9 at the subln of each
# DSEB's MultiheadDiffAttn (3); K11 at every depthwise 3×3 stride-1 conv with
# padding = dilation (the 16 PVT DWConvs of b2's 3+4+6+3 blocks, the 4 CFAM
# CAggMlp.dwconvs, the 12 dilated SepConvBN depthwise convs of the 4
# MultiOrderDWConvs, the 3 EUCB up_dwc of up1–up3: 35); K12 at the 4 OutHead
# convs inside its domain (rb.0.conv2, up.1, out.0.conv1, out.0.conv2)
SWAPPED_PER_FORWARD = {"rms_norm": 3, "depthwise_fwd": 35, "conv_small_c_fwd": 4}
VOLUME_PER_CHUNK["swapped"] = {**VOLUME_PER_CHUNK["interleaved"], **SWAPPED_PER_FORWARD}
# per train step: the backward adds one K11 forward (dx) and one dw per
# depthwise site and one fused K12 backward per K12 site; K9's backward is plain
TRAIN_PER_STEP["swapped"] = {**TRAIN_PER_STEP["interleaved"], **SWAPPED_PER_FORWARD, "depthwise_fwd": 70,
                             "depthwise_dw": 35, "conv_small_c_bwd": 4}
ROTARY_PER_FORWARD = {"diff_attention_interleaved_fwd": 1, "rms_norm": 1, "rotary": 2}
NEG = "tools/negative_results"
SWAP_KERNELS = {
    "rms_norm": dict(k="K9", source="cenet_tpu_torch/csrc/rms_norm.cu",
                     replaces="cenet_tpu/ops/rms_norm.py:47 (_rms_fwd_impl)", path="volume-swapped"),
    "rotary": dict(k="K10", source="cenet_tpu_torch/csrc/rotary.cu",
                   replaces="cenet_tpu/ops/rotary.py:62 (apply_rotary_emb_pallas)", path="rotary"),
    "depthwise_fwd": dict(k="K11", source="cenet_tpu_torch/csrc/depthwise_conv.cu",
                          replaces=f"{NEG}/depthwise.py:87 (_pallas_depthwise_fwd)", path="volume-swapped"),
    "depthwise_dw": dict(k="K11", source="cenet_tpu_torch/csrc/depthwise_conv.cu",
                         replaces=f"{NEG}/depthwise.py:105 (_pallas_depthwise_dw)", path="train-swapped"),
    "conv_small_c_fwd": dict(k="K12", source="cenet_tpu_torch/csrc/smallc_conv.cu",
                             replaces=f"{NEG}/smallc_conv.py:200 (_pallas_conv_fwd)", path="volume-swapped"),
    "conv_small_c_bwd": dict(k="K12", source="cenet_tpu_torch/csrc/smallc_conv.cu",
                             replaces=f"{NEG}/smallc_conv.py:224 (_pallas_conv_bwd)", path="train-swapped"),
}


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def is_depthwise_site(conv) -> bool:
    """A depthwise 3×3 stride-1 conv whose padding equals its dilation (K11's function)."""
    c = conv.in_channels
    return (conv.groups == c == conv.out_channels and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == conv.dilation and conv.dilation[0] == conv.dilation[1]
            and conv.padding_mode == "zeros")


def smallc_site(conv, x):
    """(NHWC shape, HWIO shape, padding) when the conv on x is inside K12's domain, else None."""
    if conv.groups != 1 or conv.dilation != (1, 1) or conv.padding_mode != "zeros" or conv.stride != (1, 1):
        return None
    if conv.padding[0] != conv.padding[1] or conv.kernel_size[0] != conv.kernel_size[1]:
        return None
    x_shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    w_shape = (*conv.kernel_size, conv.in_channels, conv.out_channels)
    return (x_shape, w_shape, conv.padding[0]) if SCK.in_domain(x_shape, w_shape, conv.padding[0]) else None


@contextlib.contextmanager
def swapped_ops(log=None):
    """While open, CUDA tensors take K9–K12 at their own sites, as the JAX
    package would if it routed them (it routes none): ``RMSNorm.forward`` →
    ``rms_norm`` (K9; ``RMSNormFn`` under autograd), the depthwise 3×3 convs →
    ``depthwise_conv3x3`` (K11), the convs inside K12's domain → ``conv_small_c``
    (K12), each plus its bias; every other conv keeps cuDNN. Interleaved rotary
    (``ops.rotary.apply_rotary_emb``) goes through K10: de-interleave the head
    dim, K10, re-interleave. ``log``: a list that gets one entry per swapped
    call (kernel, shapes), and one per K11 dw call of a backward with the
    layouts of x and g (``dw_layout``). The package itself has no switch."""
    rms_forward, conv_forward, plain_rotary = L.RMSNorm.forward, L.Conv2d.forward, ROT.apply_rotary_emb
    dw_kernel = DWK.depthwise_dw

    def rms(self, x):
        if not x.is_cuda:
            return rms_forward(self, x)
        if log is not None:
            log.append(("rms_norm", tuple(x.shape)))
        if _records(x, self.weight):
            return RMS.RMSNormFn.apply(x, self.weight, self.eps)
        return RMS.rms_norm(x, self.weight, self.eps)

    def conv(self, x):
        if not x.is_cuda:
            return conv_forward(self, x)
        w = self.weight.to(x.dtype).permute(2, 3, 1, 0)
        xh = x.permute(0, 2, 3, 1)
        site = smallc_site(self, x)
        if is_depthwise_site(self):
            if log is not None:
                log.append(("depthwise", tuple(xh.shape), self.dilation[0], x.stride(1) == 1))
            y = DWK.depthwise_conv3x3(xh, w, self.dilation[0])
        elif site is not None:
            if log is not None:
                log.append(("smallc", *site, x.stride(1) == 1))
            y = SCK.conv_small_c(xh, w, site[2])
        else:
            return conv_forward(self, x)
        y = y.permute(0, 3, 1, 2)
        return y if self.bias is None else y + self.bias.to(x.dtype).view(1, -1, 1, 1)

    def rotary(x, cos, sin, interleaved=True):
        if x.is_cuda and interleaved and 2 * cos.shape[-1] == x.shape[-1]:
            return ROT.reinterleave(ROT.apply_rotary_emb_kernel(ROT.deinterleave(x), cos, sin))
        return plain_rotary(x, cos, sin, interleaved)

    def dw(x, g, dilation=1):
        if log is not None:
            log.append(("depthwise_dw", tuple(x.shape), dilation, dw_layout(x), dw_layout(g)))
        return dw_kernel(x, g, dilation)

    L.RMSNorm.forward, L.Conv2d.forward, ROT.apply_rotary_emb = rms, conv, rotary
    DWK.depthwise_dw = dw  # DepthwiseConvFn.backward's call
    try:
        yield
    finally:
        L.RMSNorm.forward, L.Conv2d.forward, ROT.apply_rotary_emb = rms_forward, conv_forward, plain_rotary
        DWK.depthwise_dw = dw_kernel


def dw_layout(t):
    """An NHWC tensor's layout as a K11 dw call receives it: (element strides,
    storage offset), which the batch size does not change."""
    return tuple(t.stride()), t.storage_offset()


def layout_name(layout):
    """channels-last (unit channel stride), NCHW (unit W stride) or other."""
    strides = layout[0]
    return "channels_last" if strides[3] == 1 else "nchw" if strides[2] == 1 else "other"


def dw_layout_counts(log):
    """{(map shape without the batch, dilation, x layout, g layout): calls} of the
    K11 dw entries of a swapped ``log``."""
    return collections.Counter((site[1][1:], *site[2:]) for site in log if site[0] == "depthwise_dw")


def swapped_sites():
    """Every swapped call of one bf16 forward of CENet-b2 (Synapse preset) at
    batch 2: {(kernel, shapes at batch 2, …): calls per forward}; and every K11
    dw call of one bf16 train-mode forward and backward at batch 2, with the
    layouts of x and g that the backward hands over."""
    cfg = get_preset("synapse")
    model = build_model(cfg, device=DEV, seed=0)
    log, train_log = [], []
    with torch.inference_mode(), swapped_ops(log):
        model(torch.zeros(2, 1, 224, 224, device=DEV, dtype=torch.bfloat16))
    # the train step's forward and backward (Trainer.loss_and_grads) on 2 labelled images
    model.train()
    L.set_generator(model, torch.Generator(device=DEV).manual_seed(0))
    images, labels = labelled_slices(11, 2, 224)
    criterion = Criterion(cfg.model.num_classes, cfg.train.loss_type, cfg.train.loss_weights)
    with swapped_ops(train_log):
        loss = criterion(model(images.to(DEV, torch.bfloat16)).float(), labels.to(DEV))
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    del model, loss
    counts = collections.Counter(log) + collections.Counter(e for e in train_log if e[0] == "depthwise_dw")
    got = {k: sum(n for site, n in counts.items() if site[0] == kind)
           for k, kind in (("rms_norm", "rms_norm"), ("depthwise_fwd", "depthwise"), ("conv_small_c_fwd", "smallc"),
                           ("depthwise_dw", "depthwise_dw"))}
    want = {**SWAPPED_PER_FORWARD, "depthwise_dw": TRAIN_PER_STEP["swapped"]["depthwise_dw"]}
    check(got == want, f"swapped sites per forward (dw per backward) {got}, expected {want}")
    return counts


def with_batch(shape, b):
    return (b, *shape[1:])


def strided_input(shape, layout, dtype, gen):
    """An NHWC tensor of ``shape`` with the element strides and storage offset of
    ``layout`` (``dw_layout``), as the train step hands it to K11's dw."""
    strides, offset = layout
    if 0 in strides:  # an expanded gradient: the same values along that dim
        base = torch.randn([1 if st == 0 else n for n, st in zip(shape, strides)], generator=gen, device=DEV)
        return base.to(dtype).expand(shape)
    size = offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    t = torch.zeros(size, dtype=dtype, device=DEV).as_strided(shape, strides, offset)
    t.copy_(torch.randn(shape, generator=gen, device=DEV))
    return t


def nhwc_input(shape, channels_last, dtype, gen, scale=1.0):
    """An NHWC tensor of ``shape`` laid out as the model hands it over: channels-last
    memory, or the permuted view of an NCHW tensor."""
    b, h, w, c = shape
    if channels_last:
        return (scale * torch.randn(b, h, w, c, generator=gen, device=DEV)).to(dtype)
    return (scale * torch.randn(b, c, h, w, generator=gen, device=DEV)).to(dtype).permute(0, 2, 3, 1)


def close_check(got, want, dtype, where, fp32_tol=TOL_FP32):
    """``got`` against the fp32 ``want``: fp32 within ``fp32_tol``·max |want| and
    1e-5 in norm (order of summation and the card's fused multiply-adds);
    bf16 outputs within two bf16 half-ulps of max |want| and 2·2^-8 in norm
    (rounding the output, and values that kernel and twin round to different
    sides). Returns the readings."""
    e, m, ne = amax(got.float() - want.float()), amax(want), rel_norm(got, want)
    lim, nlim = (fp32_tol * m, TOL_FP32_NORM) if dtype == torch.float32 else (2 * BF16_REL * m, 2 * BF16_REL)
    check(got.shape == want.shape and e <= lim and ne <= nlim,
          f"{where}: err {e} (limit {lim}), norm err {ne} (limit {nlim}), "
          f"shapes {tuple(got.shape)} {tuple(want.shape)}")
    return {"err": e, "limit": lim, "share": e / lim, "norm_err": ne, "max_abs": m}


def elem_bound(flops, nbytes):
    """(ms for the operations, ms for the bytes) as ``bound`` computes them."""
    return flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


def swap_site_rows(counts):
    """K9, K11 and K12 against their twins at every site shape of the swapped
    paths: batch 2 and the path's own batch (32-slice chunk for the forwards,
    training batch 8 for the backward kernels; K11's dw with x and g in the
    layouts the backward hands over), fp32 and bf16; times (bf16, at the path's
    batch) of kernel, twin and library call (CUDA events; for K11's dw also the
    device time, ``graph_ms`` on ``rotated`` inputs), and the bound. Yields one row per
    (kernel, site shape), with its calls per forward."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    f = torch.nn.functional
    for site, calls in sorted(counts.items(), key=str):
        kind = site[0]
        if kind == "rms_norm":
            shape = site[1]
            row = {"kernel": "rms_norm", "site": shape, "calls_per_forward": calls}
            for b, label in ((2, "b2"), (CHUNK, "chunk")):
                for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    x = (3 * torch.randn(with_batch(shape, b), generator=gen, device=DEV)).to(dtype)
                    r = close_check(RMS.rms_norm(x), RMS.rms_norm_plain(x.float()), dtype,
                                    f"rms_norm {shape} {label} {dname}", fp32_tol=1e-5)
                    row.update({f"{label}_{dname}_{k}": v for k, v in r.items()})
            w = torch.randn(shape[-1], generator=gen, device=DEV)
            row.update({f"weight_{k}": v for k, v in close_check(RMS.rms_norm(x, w), RMS.rms_norm_plain(x.float(), w),
                                                                  x.dtype, f"rms_norm {shape} with weight").items()})
            row["ms"] = time_ms(lambda: RMS.rms_norm(x))
            row["plain_ms"] = time_ms(lambda: RMS.rms_norm_plain(x))
            row["library_ms"] = time_ms(lambda: f.rms_norm(x, (x.shape[-1],), None, 1e-5))
            # device time: a CUDA graph of calls on copies of x that pass twice the L2
            sets = rotated((x,))
            row["device_ms"] = graph_ms(RMS.rms_norm, sets)
            row["library_device_ms"] = graph_ms(lambda x: f.rms_norm(x, (x.shape[-1],), None, 1e-5), sets)
            del sets
            row["ops_ms"], row["bytes_ms"] = elem_bound(3 * x.numel(), 2 * 2 * x.numel())
            yield row
        elif kind == "depthwise":
            _, shape, dil, cl = site
            c = shape[-1]
            row = {"kernel": "depthwise_fwd", "site": shape, "dilation": dil, "channels_last": cl,
                   "calls_per_forward": calls}
            w = torch.randn(3, 3, 1, c, generator=gen, device=DEV)
            for b, label in ((2, "b2"), (CHUNK, "chunk")):
                for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    x = nhwc_input(with_batch(shape, b), cl, dtype, gen)
                    where = f"{shape} dilation {dil} {label} {dname}"
                    y = DWK.depthwise_fwd(x, w, dil)
                    r = close_check(y, DWK.depthwise_fwd_plain(x.float(), w, dil), dtype, f"depthwise_fwd {where}")
                    row.update({f"{label}_{dname}_{k}": v for k, v in r.items()})
                    # every output element from one thread: two runs give the same bits
                    same = bool(torch.equal(y, DWK.depthwise_fwd(x, w, dil)))
                    row[f"{label}_{dname}_repeat_bit_identical"] = same
                    check(same, f"depthwise_fwd {where}: repeat runs differ")
                    del y
            x = nhwc_input(with_batch(shape, CHUNK), cl, torch.bfloat16, gen)
            xn, wn = x.permute(0, 3, 1, 2), w.to(torch.bfloat16).permute(3, 2, 0, 1)
            row["ms"] = time_ms(lambda: DWK.depthwise_fwd(x, w, dil))
            row["plain_ms"] = time_ms(lambda: DWK.depthwise_fwd_plain(x, w, dil), reps=2)
            row["library_ms"] = time_ms(lambda: f.conv2d(xn, wn, padding=dil, dilation=dil, groups=c))
            row["ops_ms"], row["bytes_ms"] = elem_bound(18 * x.numel(), 2 * 2 * x.numel() + 4 * 9 * c)
            yield row
        elif kind == "depthwise_dw":
            # the dw call as the backward makes it: x and g in the layouts it hands over
            _, shape, dil, xl, gl = site
            c = shape[-1]
            row = {"kernel": "depthwise_dw", "site": shape, "dilation": dil, "x_layout": layout_name(xl),
                   "g_layout": layout_name(gl), "x_strides": xl[0], "g_strides": gl[0], "calls_per_forward": calls}
            for b, label in ((2, "b2"), (TRAIN_B, f"b{TRAIN_B}")):
                for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    x, g = (strided_input(with_batch(shape, b), lay, dtype, gen) for lay in (xl, gl))
                    where = f"{shape} dilation {dil} {label} {dname}"
                    dw = DWK.depthwise_dw(x, g, dil)
                    row["route"] = DWK.dw_plan(x, g, dil)[0]
                    r = close_check(dw, DWK.depthwise_dw_plain(x.float(), g.float(), dil), torch.float32,
                                    f"depthwise_dw {where}")
                    row.update({f"{label}_{dname}_{k}": v for k, v in r.items()})
                    same = bool(torch.equal(dw, DWK.depthwise_dw(x, g, dil)))
                    row[f"{label}_{dname}_repeat_bit_identical"] = same
                    check(same, f"depthwise_dw {where}: repeat runs differ")
            x, g = (strided_input(with_batch(shape, TRAIN_B), lay, torch.bfloat16, gen) for lay in (xl, gl))
            wn = torch.randn(c, 1, 3, 3, generator=gen, device=DEV).to(torch.bfloat16)

            def library(x, g):
                return torch.ops.aten.convolution_backward(g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wn, None,
                                                           [1, 1], [dil, dil], [dil, dil], False, [0, 0], c,
                                                           [False, True, False])

            # device time: a CUDA graph of calls on copies of x and g that pass twice the L2
            sets = rotated((x, g))
            row["ms"] = time_ms(lambda: DWK.depthwise_dw(x, g, dil))
            row["device_ms"] = graph_ms(lambda x, g: DWK.depthwise_dw(x, g, dil), sets)
            row["plain_ms"] = time_ms(lambda: DWK.depthwise_dw_plain(x, g, dil), reps=2)
            row["library_ms"] = time_ms(lambda: library(x, g))
            row["library_device_ms"] = graph_ms(library, sets)
            del sets
            row["ops_ms"], row["bytes_ms"] = elem_bound(18 * x.numel(), 2 * 2 * x.numel() + 4 * 9 * c)
            yield row
        elif kind == "smallc":
            _, shape, wshape, pad, cl = site
            k, cin, cout = wshape[0], wshape[2], wshape[3]
            row = {"kernel": "conv_small_c_fwd", "site": shape, "w": wshape, "channels_last": cl,
                   "calls_per_forward": calls}
            brow = {"kernel": "conv_small_c_bwd", "site": shape, "w": wshape, "channels_last": cl,
                    "calls_per_forward": calls}
            w = 0.1 * torch.randn(wshape, generator=gen, device=DEV)
            for b, label in ((2, "b2"), (CHUNK, "chunk"), (TRAIN_B, f"b{TRAIN_B}")):
                for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    x = nhwc_input(with_batch(shape, b), cl, dtype, gen)
                    wr = w.to(dtype).float()  # the weights as the kernel rounds them
                    where = f"{shape} w {wshape} {label} {dname}"
                    if label != f"b{TRAIN_B}":
                        y = SCK.conv_small_c_fwd(x, w, pad)
                        r = close_check(y, SCK.conv_small_c_plain(x.float(), wr, pad), dtype,
                                        f"conv_small_c_fwd {where}")
                        row.update({f"{label}_{dname}_{k_}": v for k_, v in r.items()})
                        # every output element from one block: two runs give the same bits
                        same = bool(torch.equal(y, SCK.conv_small_c_fwd(x, w, pad)))
                        row[f"{label}_{dname}_repeat_bit_identical"] = same
                        check(same, f"conv_small_c_fwd {where}: repeat runs differ")
                        del y
                    if label != "chunk":
                        g = nhwc_input((b, shape[1], shape[2], cout), False, dtype, gen)
                        dx, dw = SCK.conv_small_c_bwd(x, w, g, pad)
                        want_dx, want_dw = SCK.conv_small_c_bwd_plain(x.float(), wr, g.float(), pad)
                        for name, got, want, dt in (("dx", dx, want_dx, dtype), ("dw", dw, want_dw, torch.float32)):
                            r = close_check(got, want, dt, f"conv_small_c_bwd {name} {where}")
                            brow.update({f"{label}_{dname}_{name}_{k_}": v for k_, v in r.items()})
                        dx2, dw2 = SCK.conv_small_c_bwd(x, w, g, pad)
                        brow["repeat_bit_identical"] = bool(torch.equal(dw, dw2))
                        brow["dx_repeat_bit_identical"] = bool(torch.equal(dx, dx2))
                        check(brow["repeat_bit_identical"] and brow["dx_repeat_bit_identical"],
                              f"conv_small_c_bwd {where}: repeat runs differ (dw {brow['repeat_bit_identical']}, "
                              f"dx {brow['dx_repeat_bit_identical']})")
                        del dx2, dw2
            del x, g, dx, dw, want_dx, want_dw
            x = nhwc_input(with_batch(shape, CHUNK), cl, torch.bfloat16, gen)
            xn, wn = x.permute(0, 3, 1, 2), w.to(torch.bfloat16).permute(3, 2, 0, 1)
            row["ms"] = time_ms(lambda: SCK.conv_small_c_fwd(x, w, pad))
            row["plain_ms"] = time_ms(lambda: SCK.conv_small_c_plain(x, w, pad), reps=2)
            row["library_ms"] = time_ms(lambda: f.conv2d(xn, wn, padding=pad))
            pix = CHUNK * shape[1] * shape[2]
            row["ops_ms"], row["bytes_ms"] = elem_bound(2 * k * k * cin * cout * pix,
                                                        2 * pix * (cin + cout) + 4 * w.numel())
            yield row
            x = nhwc_input(with_batch(shape, TRAIN_B), cl, torch.bfloat16, gen)
            g = nhwc_input((TRAIN_B, shape[1], shape[2], cout), False, torch.bfloat16, gen)
            xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            brow["ms"] = time_ms(lambda: SCK.conv_small_c_bwd(x, w, g, pad))
            brow["plain_ms"] = time_ms(lambda: SCK.conv_small_c_bwd_plain(x, w, g, pad), reps=2)
            brow["library_ms"] = time_ms(lambda: torch.ops.aten.convolution_backward(
                gn, xn, wn, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1, [True, True, False]))
            pix = TRAIN_B * shape[1] * shape[2]
            brow["ops_ms"], brow["bytes_ms"] = elem_bound(4 * k * k * cin * cout * pix,
                                                          2 * pix * (2 * cin + cout) + 2 * 4 * w.numel())
            yield brow
        torch.cuda.empty_cache()


def phase_swap_kernels():
    """K9, K11 and K12 against their twins at every site shape (``swap_site_rows``).
    Returns the rows (each with its calls per forward), each kernel's
    largest bf16 error against its twin, and the layouts of K11's dw calls
    (``dw_layout_counts``) at batch 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = swapped_sites()
    rows = []
    for row in swap_site_rows(counts):
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = bound_by(row["ops_ms"], row["bytes_ms"])
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        if "device_ms" in row:
            row["device_roofline_share"] = row["bound_ms"] / row["device_ms"]
        emit({"phase": "swap_kernels", **{k: (list(v) if isinstance(v, tuple) else v) for k, v in row.items()}})
        rows.append(row)
    # K9 over its sites by device time, against its bound: the share that says
    # whether K9 keeps its design (at least half of the bound) or is redesigned
    k9 = [r for r in rows if r["kernel"] == "rms_norm"]
    k9_total = {k: sum(r[k] * r["calls_per_forward"] for r in k9)
                for k in ("device_ms", "library_device_ms", "bound_ms", "ms")}
    emit({"phase": "k9_device_time", "sites": len(k9), **k9_total,
          "device_roofline_share": k9_total["bound_ms"] / k9_total["device_ms"]})
    errs = {}
    for row in rows:
        e = max(v for k, v in row.items() if k.endswith("bf16_err") or k.endswith("bf16_dx_err")
                or k.endswith("bf16_dw_err"))
        errs[row["kernel"]] = max(errs.get(row["kernel"], 0.0), e)
    binding.reset_launches()
    return rows, errs, dw_layout_counts(counts.elements())


def phase_swapped_volume():
    """The volume path with K9, K11 and K12 swapped in: one 32-slice chunk
    through ``make_predict_fn`` against the unswapped chunk, in fp32 (TF32 off;
    probabilities within phase 3's 1e-3) and in bf16 (the swap's rounding
    points differ from cuDNN's: the bias is added after the kernel's rounding,
    and sums run in another order; so the swapped bf16 chunk is held to lie no
    further from the fp32 chunk than twice the unswapped bf16 chunk does),
    argmax agreement ≥ 99.9% in both, launch counts checked exactly; the bf16
    chunk's forward timed with CUDA events, unswapped and swapped in turns; then a synthetic
    64-slice case through ``VolumeInferencer`` in bf16 in turns (plain,
    swapped, swapped, plain): labels agreeing on ≥ 99.9% of voxels, slices/s,
    and the launch counts of one swapped run. Returns those counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(get_preset("synapse"), device=DEV, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(4)
    x = torch.randn(CHUNK, 1, 224, 224, generator=gen, device=DEV)
    readings, plain = {}, {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        predict = make_predict_fn(model, dtype)
        plain[dname] = predict(x)
        binding.reset_launches()
        with swapped_ops():
            swapped = predict(x)
        torch.cuda.synchronize()
        launched = dict(binding.LAUNCHES)
        check_launches(launched, VOLUME_PER_CHUNK["swapped"], 1, f"swapped chunk ({dname})")
        readings[dname] = {"chunk_max_abs_prob_diff": amax(swapped - plain[dname]),
                           "chunk_argmax_agree": float((swapped.argmax(1) == plain[dname].argmax(1)).float().mean()),
                           "chunk_max_abs_prob_diff_vs_fp32": amax(swapped - plain["fp32"]), "launches": launched}
    bf16_drift = amax(plain["bf16"] - plain["fp32"])
    del plain, swapped
    predict = make_predict_fn(model, torch.bfloat16)
    # the bf16 chunk's forward (CUDA events), unswapped and swapped in turns
    chunk_ms = {"plain": [], "swapped": []}
    for run in ("plain", "swapped", "swapped", "plain"):
        with swapped_ops() if run == "swapped" else contextlib.nullcontext():
            chunk_ms[run].append(time_ms(lambda: predict(x)))
    inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=224, chunk=CHUNK, num_classes=9), device=DEV)
    image = synthetic_case(1)["image"]
    chunks = -(-image.shape[0] // CHUNK)
    inf.predict_volume(image[:CHUNK])
    with swapped_ops():
        inf.predict_volume(image[:CHUNK])  # warm-up of both
    seconds, labels = {"plain": [], "swapped": []}, {}
    for run in ("plain", "swapped", "swapped", "plain"):
        with swapped_ops() if run == "swapped" else contextlib.nullcontext():
            binding.reset_launches()
            t0 = time.perf_counter()
            labels[run] = inf.predict_volume(image)
            seconds[run].append(time.perf_counter() - t0)
            launched = dict(binding.LAUNCHES)
        check_launches(launched, VOLUME_PER_CHUNK["swapped" if run == "swapped" else "interleaved"], chunks,
                       f"swapped volume ({run})")
        if run == "swapped":
            case_launches = launched
    label_agree = float((labels["swapped"] == labels["plain"]).mean())
    emit({"phase": "swapped_volume", **{f"{d}_{k}": v for d, r in readings.items() for k, v in r.items()},
          "bf16_vs_fp32_max_abs_prob_diff_unswapped": bf16_drift, "bf16_chunk_forward_ms": chunk_ms,
          "case_label_agree": label_agree, "slices": int(image.shape[0]), "chunks": chunks,
          "slices_per_s": {r: [image.shape[0] / t for t in ts] for r, ts in seconds.items()},
          "launches_swapped_case": case_launches})
    r32, r16 = readings["fp32"], readings["bf16"]
    check(r32["chunk_max_abs_prob_diff"] <= 1e-3 and r32["chunk_argmax_agree"] >= 0.999,
          f"swapped volume: fp32 chunk probabilities off by {r32['chunk_max_abs_prob_diff']}, "
          f"argmax agreement {r32['chunk_argmax_agree']}")
    check(r16["chunk_max_abs_prob_diff_vs_fp32"] <= 2 * bf16_drift and r16["chunk_argmax_agree"] >= 0.999,
          f"swapped volume: bf16 chunk probabilities {r16['chunk_max_abs_prob_diff_vs_fp32']} from fp32 (the "
          f"unswapped bf16 chunk: {bf16_drift}), argmax agreement {r16['chunk_argmax_agree']}")
    check(label_agree >= 0.999, f"swapped volume: labels agree on {label_agree} of the case")
    del model
    torch.cuda.empty_cache()
    return case_launches


# phase 4d's runs after the CLI's, labels only: (transfer dtype, host zoom,
# chunk loop); the float32 loops go in turns, overlapped first
CLI_MODES = [("float32", False, "overlapped"), ("float32", False, "serial"), ("float32", False, "serial"),
             ("float32", False, "overlapped"), ("uint16", False, "overlapped"), ("uint16", False, "serial"),
             ("float16", False, "overlapped"), ("float16", False, "serial"), ("uint8", False, "overlapped"),
             ("uint8", False, "serial"), ("float32", True, "overlapped"), ("float32", True, "serial")]


def run_mode(predict, mode, host_zoom, run, images):
    """Labels of ``images`` through one transfer mode and chunk loop (the
    serial loop through the engine's private ``_predict_chunked``), and the
    run's timings and staging allocations (after the first image, at the end)."""
    vcfg = VolumeInferenceConfig(img_size=224, chunk=CHUNK, num_classes=9, transfer_dtype=mode, host_zoom=host_zoom)
    inf = VolumeInferencer(predict, vcfg, device=DEV)
    if run == "serial":
        inf.predict_volume = lambda image: inf._predict_chunked(image, inf._run_serial)
    inf.predict_volume(images[0][:CHUNK])  # warm-up: the zoom matrices of this path
    rec = instrument(inf)
    got = [inf.predict_volume(images[0])]
    first = inf.staging.allocations
    got += [inf.predict_volume(image) for image in images[1:]]
    return got, {**read(rec), "staging_allocations": [first, inf.staging.allocations]}


def agreement(got, want) -> float:
    return float(np.mean([(g == w).mean() for g, w in zip(got, want)]))


def phase_cli_eval(volume):
    """4d: ``python -m cenet_tpu_torch.cli.main eval`` driven in-process on the
    card over phase 4's two synthetic 64 × 512 × 512 cases (``.npy.h5`` files
    when ``h5py`` is installed, else an in-memory ``volumes()``), with the
    seeded CENet-b2 of phase 4 saved as a ``.pth`` and ``--is_savenii``: K1
    and K2 launched as ``VOLUME_PER_CHUNK`` counts, the printed mean dice in
    [0, 1] and HD95 finite, both equal to phase 4's ``run_inference`` on the
    same weights, the NIfTI files read back equal to phase 4's labels and the
    cases, and HD95 with the native EDT within 1e-9 of scipy's on one class of
    one case. The CLI's per-class metrics are phase 4's (``MetricMemo``: every
    mask pair it asks for was computed there), so the metrics run once. Then
    the same cases through each transfer mode, serial and overlapped, on the
    checkpoint loaded again (labels only): float32 overlapped equal to phase
    4's labels, float32 serial and overlapped equal to the bit, float16 and
    the host zoom agreeing with float32 on ≥ 99.9% of voxels (uint16 and
    uint8 printed: their codes are not the intensities on [0, 1] volumes), the
    pinned staging buffers made in the first case only; and one HU-like case
    (``hu_case``), where uint16 carries the intensities, uint16 equal to
    float32 to the bit on both loops. Slices/s, step-event ms and back-zoom ms
    a chunk for each run. Returns the CLI run's launch counts."""
    import io

    from scipy import ndimage

    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core.checkpoint import load_checkpoint
    from cenet_tpu_torch.evaluate import metrics as MET
    from cenet_tpu_torch.evaluate.nifti import read_nifti

    try:
        import h5py
    except ImportError:
        h5py = None
    cfg = get_preset("synapse")
    cases, preds, want, memo = volume["cases"], volume["preds"], volume["result"], volume["metrics"]
    chunks = sum(-(-c["image"].shape[0] // CHUNK) for c in cases)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "cenet_b2.pth")
        torch.save(build_model(cfg, device=DEV, seed=0).state_dict(), pth)  # phase 4's weights
        test_set = InMemoryVolumes(cases)
        if h5py is not None:
            for c in cases:
                with h5py.File(os.path.join(tmp, f"{c['case_name']}.npy.h5"), "w") as f:
                    f["image"], f["label"] = c["image"], c["label"]
            with open(os.path.join(tmp, "test_vol.txt"), "w") as f:
                f.write("".join(f"{c['case_name']}\n" for c in cases))
            test_set = None
        argv = ["eval", "--preset", "synapse", "--checkpoint", pth, "--root_path", tmp, "--list_dir", tmp,
                "--output_dir", os.path.join(tmp, "out"), "--is_savenii"]
        out = io.StringIO()
        memo.misses = 0
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), memo.installed():
            result = cli.main(argv, test_set=test_set)
        cli_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        printed = json.loads(out.getvalue().strip().splitlines()[-1])
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
        nifti_equal = all(
            np.array_equal(read_nifti(os.path.join(snap, "predictions", f"{c['case_name']}_{kind}.nii.gz")), ref)
            for c in cases for kind, ref in (("pred", preds[c["case_name"]]), ("img", c["image"]),
                                             ("gt", c["label"])))
        model = load_checkpoint(build_model(cfg, device=DEV, seed=1), pth)
    # HD95 of one class of the first case, with the native EDT and with scipy's
    case, pred = cases[0], preds[cases[0]["case_name"]]
    cls = next((k for k in range(1, 9) if (pred == k).any() and (case["label"] == k).any()), None)
    a, b = (pred == cls, case["label"] == cls) if cls else (case["label"] == 1, np.roll(case["label"] == 1, 3, 2))
    hd_native = MET.hd95(a, b)
    native_edt, MET.edt = MET.edt, ndimage.distance_transform_edt
    try:
        hd_scipy = MET.hd95(a, b)
    finally:
        MET.edt = native_edt
    emit({"phase": "cli_eval", "h5py": h5py is not None, "seconds": cli_s, "printed": printed,
          "run_inference": want, "metrics_from_phase_4": len(memo.seen) - memo.misses, "metric_misses": memo.misses,
          "launches": launches, "chunks": chunks, "nifti_read_back_equal": nifti_equal,
          "hd95_class": cls, "hd95_native": hd_native, "hd95_scipy": hd_scipy,
          "log": out.getvalue().strip().splitlines()[-3:-1]})
    check_launches(launches, VOLUME_PER_CHUNK["interleaved"], chunks, f"cli eval, {chunks} chunks")
    check(printed == result and 0.0 <= printed["mean_dice"] <= 1.0 and np.isfinite(printed["mean_hd95"]),
          f"cli eval printed {printed}")
    check(printed == want, f"cli eval {printed} is not run_inference's {want} on the same weights")
    check(memo.misses == 0, f"cli eval: {memo.misses} mask pairs that phase 4 did not see")
    check(nifti_equal, "cli eval: the NIfTI files do not read back equal")
    check(abs(hd_native - hd_scipy) <= 1e-9, f"HD95 native {hd_native} against scipy {hd_scipy}")

    predict = make_predict_fn(model, torch.bfloat16)
    images = [c["image"] for c in cases]
    labels = {}
    for mode, host_zoom, run in CLI_MODES:
        name = f"{mode}{' host_zoom' if host_zoom else ''} {run}"
        got, row = run_mode(predict, mode, host_zoom, run, images)
        labels.setdefault(name, got)
        row = {"mode": name, **row, "label_agree_vs_float32": agreement(got, labels["float32 overlapped"])}
        emit({"phase": "cli_eval_modes", **row})
        check(row["staging_allocations"][0] == row["staging_allocations"][1],
              f"{name}: staging buffers made after the first case")
        check(all(np.array_equal(g, l) for g, l in zip(got, labels[name])), f"{name}: two runs differ")
    ref = labels["float32 overlapped"]
    check(all(np.array_equal(p, preds[c["case_name"]]) for p, c in zip(ref, cases)),
          "float32 overlapped labels are not phase 4's")
    for name, limit in (("float32 serial", 1.0), ("float16 overlapped", 0.999),
                        ("float32 host_zoom overlapped", 0.999)):
        agree = agreement(labels[name], ref)
        exact = all(np.array_equal(g, w) for g, w in zip(labels[name], ref))
        check(exact if limit == 1.0 else agree >= limit, f"{name}: labels agree with float32's on {agree}")
    for mode in ("uint16", "float16", "uint8", "float32 host_zoom"):
        check(all(np.array_equal(g, w) for g, w in zip(labels[f"{mode} serial"], labels[f"{mode} overlapped"])),
              f"{mode}: serial and overlapped labels differ")
    hu = [hu_case(3)["image"]]
    hu_labels = {}
    for mode, run in (("float32", "overlapped"), ("uint16", "overlapped"), ("uint16", "serial")):
        hu_labels[f"{mode} {run}"] = run_mode(predict, mode, False, run, hu)[0]
    hu_exact = {name: all(np.array_equal(g, w) for g, w in zip(got, hu_labels["float32 overlapped"]))
                for name, got in hu_labels.items()}
    emit({"phase": "cli_eval_uint16_hu", "slices": int(hu[0].shape[0]), "equal_to_float32": hu_exact})
    check(all(hu_exact.values()), f"uint16 on integer volumes: labels not float32's to the bit ({hu_exact})")
    del model, predict
    torch.cuda.empty_cache()
    return launches


def phase_swapped_train_parity(card, x2, y2, w_loss, w_grads, names, live):
    """The fp32 train step (TF32 off, drop-path off) with K9, K11 and K12
    swapped in, held against float64 runs of the same step on the CPU (the
    fp32 step is ill-conditioned, ROADMAP §3): at batch 2 against phase 3b's
    witness ``w_grads``, at the training batch of 8 against a witness of its
    own, beside the unswapped step; the loss within ``TOL_LOSS``, the median
    within ``TOL_MEDIAN_VS_F64``, the picked gradients within
    ``PARITY_GRADS``' float64 column. At batch 8 the swapped step is also held
    to the unswapped one in its loss and in the median (``TOL_B8_MEDIAN``);
    the picked gradients' differences are reported. Launch counts per step
    checked exactly. Returns the batch-8 run's counts."""
    def rel_errs(gs, ws):
        return {n: rel_max(g, w) for n, g, w in zip(names, gs, ws) if n in live}

    def hold_to_float64(grads, loss, want_loss, want_grads, where):
        vs_f64 = rel_errs(grads, want_grads)
        median = float(np.median(list(vs_f64.values())))
        check(abs(float(loss) - want_loss) <= TOL_LOSS, f"{where}: loss {float(loss)} vs float64 {want_loss}")
        check(median <= TOL_MEDIAN_VS_F64, f"{where}: gradients off float64 by a median {median}")
        for n, (lim, _, _) in PARITY_GRADS.items():
            check(vs_f64[n] <= lim, f"{where}: gradient of {n} off float64 by {vs_f64[n]} (limit {lim})")
        return vs_f64

    binding.reset_launches()
    with swapped_ops():
        loss, grads = card.loss_and_grads(x2, y2)
    torch.cuda.synchronize()
    launched = dict(binding.LAUNCHES)
    vs_f64 = rel_errs(grads, w_grads)
    emit({"phase": "swapped_train_parity", "batch": 2, "loss": float(loss), "grad_rel_err_vs_float64": summary(vs_f64),
          "launches": launched})
    check_launches(launched, TRAIN_PER_STEP["swapped"], 1, "swapped train parity, batch 2")
    hold_to_float64(grads, loss, w_loss, w_grads, "swapped train parity, batch 2")
    del grads
    x, y = labelled_slices(11, TRAIN_B, 224)
    loss, grads = card.loss_and_grads(x.to(DEV), y.to(DEV))
    binding.reset_launches()
    with swapped_ops():
        s_loss, s_grads = card.loss_and_grads(x.to(DEV), y.to(DEV))
    torch.cuda.synchronize()
    launched = dict(binding.LAUNCHES)
    witness = Trainer(parity_config(), 1, device="cpu", model_seed=0)
    witness.model.double().train()
    witness.compute_dtype = torch.float64
    t0 = time.perf_counter()
    with float64_stays():
        w8_loss, w8_grads = witness.loss_and_grads(x, y)
    witness_s = time.perf_counter() - t0
    del witness
    errs = rel_errs(s_grads, grads)
    swapped_f64, plain_f64 = rel_errs(s_grads, w8_grads), rel_errs(grads, w8_grads)
    emit({"phase": "swapped_train_parity", "batch": TRAIN_B, "loss": float(s_loss), "loss_unswapped": float(loss),
          "loss_float64": float(w8_loss), "grad_rel_err_vs_unswapped": summary(errs),
          "grad_rel_err_vs_float64": {"swapped": summary(swapped_f64), "unswapped": summary(plain_f64)},
          "float64_s": witness_s, "launches": launched})
    check_launches(launched, TRAIN_PER_STEP["swapped"], 1, f"swapped train parity, batch {TRAIN_B}")
    for run, (g, l_) in {"swapped": (s_grads, s_loss), "unswapped": (grads, loss)}.items():
        hold_to_float64(g, l_, float(w8_loss), w8_grads, f"swapped train parity, batch {TRAIN_B} ({run})")
    check(abs(float(s_loss) - float(loss)) <= TOL_LOSS,
          f"swapped train parity, batch {TRAIN_B}: loss {float(s_loss)} vs unswapped {float(loss)}")
    median = float(np.median(list(errs.values())))
    check(median <= TOL_B8_MEDIAN, f"swapped train parity, batch {TRAIN_B}: gradients off by a median {median}")
    del grads, s_grads, w8_grads
    torch.cuda.empty_cache()
    return launched


def phase_swapped_train(trainer, images, labels, dw_layouts, steps=10):
    """Phase 6's bf16 trainer on its resident batch with K9, K11 and K12 swapped
    in: the layouts of x and g that each of the step's 35 K11 dw calls
    receives (one logged step; they must be those of phase 2c's dw rows,
    ``dw_layouts``), step ms over ``steps`` steps (CUDA events), every loss
    finite, launch counts and K11 dw's routes checked exactly, and one profiled
    step beside phase 7's, with the same attention designs, K12's tensor-core
    forward (its forwards and its backwards' dx) and dw, K11's tiled forward
    and tiled dw as often as counted
    (no bf16 instance of K12's CUDA-core forward or backward)."""
    log = []
    with swapped_ops(log):
        trainer.train_step(images, labels)  # warm-up, logged
    step_layouts = dw_layout_counts(log)
    emit({"phase": "swapped_train_dw_layouts",
          "calls": [{"site": list(k[0]), "dilation": k[1], "x_layout": layout_name(k[2]), "x_strides": k[2][0],
                     "x_offset": k[2][1], "g_layout": layout_name(k[3]), "g_strides": k[3][0],
                     "g_offset": k[3][1], "calls": n} for k, n in sorted(step_layouts.items(), key=str)]})
    check(step_layouts == dw_layouts, f"K11 dw layouts of the step {dict(step_layouts)} are not phase 2c's "
          f"{dict(dw_layouts)}")
    with swapped_ops():
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        binding.reset_launches()
        DWK.DW_ROUTES.clear()
        losses = []
        start.record()
        for _ in range(steps):
            losses.append(trainer.train_step(images, labels))
        end.record()
        torch.cuda.synchronize()
        launched, routes = dict(binding.LAUNCHES), dict(DWK.DW_ROUTES)
        prof = profile_step(trainer, images, labels)
    loss_values = torch.stack(losses).cpu().tolist()
    emit({"phase": "swapped_train", "steps": steps, "resident_step_ms": start.elapsed_time(end) / steps,
          "losses": loss_values, "launches": launched, "dw_routes_per_step": {k: v / steps for k, v in routes.items()},
          "profile": prof})
    check(all(np.isfinite(loss_values)), f"a swapped training loss is not finite: {loss_values}")
    check_launches(launched, TRAIN_PER_STEP["swapped"], steps, f"swapped train, {steps} steps")
    check(sum(routes.values()) == launched["depthwise_dw"] and all(v % steps == 0 for v in routes.values()),
          f"K11 dw routes {routes} over {steps} steps")
    check_designs(prof["kernel_designs"], TRAIN_PER_STEP["swapped"], "swapped bf16 train step profile")
    return launched


def compare_states(t1, t2):
    """The tensors of two trainers' states (weights, BatchNorm buffers,
    momentum) and those that differ: their count, the first five, the largest
    difference."""
    def state(t):
        return {**{f"model.{k}": v for k, v in t.model.state_dict().items()},
                **{f"opt.{n}.{s}": x for n, slots in t.optimizer.state.items() for s, x in slots.items()}}

    a, b = state(t1), state(t2)
    unequal = sorted(k for k in a if k not in b or not torch.equal(a[k], b[k]))
    return {"tensors": [len(a), len(b)], "unequal": len(unequal), "first_unequal": unequal[:5],
            "max_abs_diff": max((amax(a[k].float() - b[k].float()) for k in unequal if k in b), default=0.0)}


def train_and_resume(root, out, epochs=2):
    """``cli train`` on the slices under ``root`` for ``epochs`` epochs without
    snapshot evals (``--eval_interval`` above ``epochs``) under ``out/full``,
    then ``--resume`` from its previous epoch's step in a copy of its snapshot
    (the last step file and ``final`` removed) under ``out/resumed``: the
    comparison of every tensor of the two final states (weights, BatchNorm
    buffers, momentum), the steps, the resume's log line, the uninterrupted
    run's img/s by ``--throughput``, the seconds of each run, and then the ms
    of its trainer's step on a resident batch."""
    import io
    import shutil

    from cenet_tpu_torch.cli import main as cli

    def train(name, *extra):
        argv = ["train", "--preset", "synapse", "--root_path", root, "--list_dir", root, "--output_dir",
                os.path.join(out, name), "--max_epochs", str(epochs), "--eval_interval", str(epochs + 1),
                "--throughput", *extra]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            trainer = cli.main(argv, test_set=InMemoryVolumes([]))
        seconds = time.perf_counter() - t0
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
        return trainer, snap, json.loads(buf.getvalue().strip().splitlines()[-1])["value"], seconds, buf.getvalue()

    full, snap, img_s, full_s, _ = train("full")
    copy = os.path.join(out, "resumed", os.path.basename(snap))
    shutil.copytree(snap, copy)
    for name in (f"steps/{full.step}.pth", "final.pth"):
        os.remove(os.path.join(copy, name))
    resumed, _, _, resumed_s, log = train("resumed", "--resume")
    result = {"steps": [full.step, resumed.step], **compare_states(full, resumed),
              "resumed_from": [line.split("] ", 1)[-1] for line in log.splitlines() if "resumed from" in line],
              "img_per_s": img_s, "full_s": full_s, "resumed_s": resumed_s}
    # then the step on a resident batch (CUDA events over 10 steps after one),
    # a longer window than --throughput's one epoch, for the settings' cost
    x, y = labelled_slices(7, TRAIN_B, 224)
    x, y = x.to(DEV), y.to(DEV)
    result["resident_step_ms"] = time_ms(lambda: full.train_step(x, y), reps=10)
    return result


# phase 6b's resume check in a fresh process, under the determinism settings
# when argv[3] is "1": CUBLAS_WORKSPACE_CONFIG must be set before the process
# first touches cuBLAS
CLI_TRAIN_RESUME = r"""
import json, os, sys
deterministic = sys.argv[3] == "1"
if deterministic:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import torch
if deterministic:
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
import chip_smoke
print(json.dumps(chip_smoke.train_and_resume(sys.argv[1], sys.argv[2])))
"""


def fresh_train_and_resume(root, deterministic):
    """``train_and_resume`` in a fresh process, under the determinism settings
    or without them: its result, and the process's seconds. Both kinds run in
    fresh processes so that their img/s compare (on an H100 a warm run in the
    long process read 33.3 img/s against 22.6 in a fresh one)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run([sys.executable, "-c", CLI_TRAIN_RESUME, root, out, "1" if deterministic else "0"],
                              cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                              timeout=600)
    check(proc.returncode == 0, f"the cli train resume process failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0


def phase_cli_train(root, train_img_per_s, epochs=2):
    """6b: ``python -m cenet_tpu_torch.cli.main train --preset synapse`` driven
    in-process on the card at full width over phase 6's 64 slices under
    ``root`` (8 iterations an epoch, so ``steps_per_call`` 10 stacks 8), two
    epochs with a snapshot eval after each (``--eval_interval 1``) on two
    seeded 16 × 512² cases held in memory, and ``--throughput``; then ``cli
    eval --checkpoint <snapshot>``. Requires K1–K4 launched as the 16 steps and
    the evals' chunks count them (no triptych fires at iterations 8 and 16),
    the tags ``epoch1``, ``epoch2`` and ``final``, at most ``ckpt_keep`` step
    files, two rows in ``result.tsv``, every loss finite, the ``--throughput``
    line, and eval's JSON equal to the ``epoch2`` snapshot's metrics (``final``
    holds the same weights; the metrics of masks seen before are read back,
    ``MetricMemo``). Then, in fresh processes, two epochs without snapshot
    evals against a ``--resume`` from the epoch-1 step (``train_and_resume``):
    under the determinism settings every tensor of the final state equal to
    the bit (required); without them, measured only.
    img/s by ``--throughput`` beside phase 6's, and the seconds of each part. Returns the in-process run's
    launch counts (training and snapshot evals)."""
    import io

    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core.checkpoint import CheckpointManager

    cfg = get_preset("synapse")
    cases = [synthetic_case(seed, d=16) for seed in (21, 22)]
    test_set = InMemoryVolumes(cases)
    memo = MetricMemo()
    losses, eval_s = [], []
    train_step, volume_eval = Trainer.train_step, cli._volume_eval

    def recording_step(self, images, labels):
        losses.append(train_step(self, images, labels))
        return losses[-1]

    def timed_eval(*a, **kw):
        t0 = time.perf_counter()
        result = volume_eval(*a, **kw)
        eval_s.append(time.perf_counter() - t0)
        return result

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["train", "--preset", "synapse", "--root_path", root, "--list_dir", root, "--output_dir", tmp,
                "--max_epochs", str(epochs), "--eval_interval", "1", "--throughput"]
        out = io.StringIO()
        K.reset_launches()
        Trainer.train_step, cli._volume_eval = recording_step, timed_eval
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), memo.installed():
                trainer = cli.main(argv, test_set=test_set)
        finally:
            Trainer.train_step, cli._volume_eval = train_step, volume_eval
        train_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        steps = trainer.step
        del trainer
        torch.cuda.empty_cache()
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
        mgr = CheckpointManager(snap)
        tags, step_files = mgr.available_tags(), mgr.all_steps()
        with open(os.path.join(snap, "result.tsv")) as f:
            rows = [line.split("\t") for line in f.read().splitlines()[1:]]
        lines = out.getvalue().strip().splitlines()
        throughput = json.loads(lines[-1])
        eval_argv = ["eval", "--preset", "synapse", "--checkpoint", snap, "--output_dir", tmp]
        eval_out = io.StringIO()
        misses = memo.misses
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(eval_out), memo.installed():
            result = cli.main(eval_argv, test_set=test_set)
        cli_eval_s = time.perf_counter() - t0
        eval_launches = dict(K.LAUNCHES)
        eval_misses = memo.misses - misses
        loss_values = torch.stack(losses).cpu().tolist()
    det, det_s = fresh_train_and_resume(root, True)
    nondet, nondet_s = fresh_train_and_resume(root, False)
    chunks = epochs * sum(-(-c["image"].shape[0] // CHUNK) for c in cases)
    snapshot = {"mean_dice": float(rows[-1][1]), "mean_hd95": float(rows[-1][2])} if rows else None
    emit({"phase": "cli_train", "epochs": epochs, "steps": steps, "losses": loss_values, "tags": tags,
          "step_files": step_files, "result_rows": rows, "throughput": throughput,
          "img_per_s": throughput.get("value"), "phase6_img_per_s": train_img_per_s,
          "train_s": train_s, "snapshot_eval_s": eval_s, "metric_misses": misses,
          "launches": launches, "snapshot_chunks": chunks,
          "cli_eval": {"printed": result, "snapshot": snapshot, "seconds": cli_eval_s, "launches": eval_launches,
                       "metric_misses": eval_misses},
          "resume_deterministic": {**det, "process_s": det_s}, "resume_default": {**nondet, "process_s": nondet_s},
          "log": [line for line in lines if "snapshot" in line or "resumed" in line or "training done" in line]})
    per_step, per_chunk = TRAIN_PER_STEP["interleaved"], VOLUME_PER_CHUNK["interleaved"]
    want = {name: per_step.get(name, 0) * steps + per_chunk.get(name, 0) * chunks for name in launches}
    check(steps == epochs * 8 and launches == want,
          f"cli train: {steps} steps, launches {launches}, expected {want} for {epochs * 8} steps and {chunks} chunks")
    check(tags == ["final"] + [f"epoch{e}" for e in range(1, epochs + 1)], f"cli train: tags {tags}")
    check(1 <= len(step_files) <= cfg.train.ckpt_keep, f"cli train: step files {step_files}")
    check(len(rows) == epochs, f"cli train: result.tsv rows {rows}")
    check(len(loss_values) == steps and all(np.isfinite(loss_values)), f"cli train: losses {loss_values}")
    check(throughput.get("metric") == "train_images_per_sec" and throughput.get("value", 0) > 0,
          f"cli train: the last line is not the --throughput line: {lines[-1]}")
    check(result == snapshot, f"cli eval of the snapshot printed {result}, the epoch-{epochs} snapshot {snapshot}")
    check_launches(eval_launches, per_chunk, chunks // epochs, "cli eval of the snapshot")
    for name, run in (("deterministic", det), ("default", nondet)):
        check(run["steps"] == [epochs * 8] * 2 and run["resumed_from"], f"cli train resume ({name}): {run}")
    check(det["unequal"] == 0 and det["tensors"][0] == det["tensors"][1],
          f"cli train resume under the determinism settings: {det['unequal']} tensors differ ({det})")
    return launches


# ---------------------------------------------------------------------------
# Phase 6h: the ('data', 'model') mesh on torch.distributed
# ---------------------------------------------------------------------------

MESH_STEPS, MESH_LOSS_RTOL, MESH_PARAM_ATOL = 2, 2e-4, 5e-4  # JAX's DP/TP gate limits
# the parameter updates' and SGD slots' errors (``mesh_relative``): of all tensors
# relative to the whole norm, and of one tensor relative to its own norm (the CPU
# gates' limits, tests/torch_mesh_ranks.py)
MESH_WHOLE_RTOL, MESH_TENSOR_RTOL = 1e-3, 1e-2
MESH_CASES = {"data2": (2, 1), "model2": (1, 2)}  # (data, model) of phase 6h (b)


def mesh_config(amp):
    """The Synapse preset (CENet-b2, 224², batch 8, SGD, BoundaryDoU, drop-path
    0.1), in bf16 as it trains (``amp``) or in fp32 for the comparisons."""
    base = get_preset("synapse")
    return base.replace(train=dataclasses.replace(base.train, amp=amp))


def mesh_steps(mesh=None):
    """``MESH_STEPS`` fp32 steps of a fresh trainer (the preset's seed) on the
    seeded batch of 8 (the rank's rows under ``mesh``), on the CPU: {"losses",
    "state" (the full state's weights and statistics), "slots" (the SGD
    momentum of each parameter), "init" (the parameters before the steps)}."""
    x, y = labelled_slices(31, TRAIN_B, 224)
    if mesh is not None:
        x, y = x[mesh.rows(TRAIN_B)], y[mesh.rows(TRAIN_B)]
    tr = Trainer(mesh_config(False), 10, device=None if mesh is None else mesh.device, mesh=mesh)
    init = {k: v.detach().cpu().clone() for k, v in tr.state_dict()["state_dict"].items()}
    x, y = x.to(tr.device), y.to(tr.device)
    losses = [float(tr.train_step(x, y)) for _ in range(MESH_STEPS)]
    full = tr.state_dict()
    slots = {n: s["trace"].cpu() for n, s in full["optimizer"]["state"].items()}
    return {"losses": losses, "state": {k: v.cpu() for k, v in full["state_dict"].items()}, "slots": slots,
            "init": {k: init[k] for k in slots}}


def mesh_relative(triples):
    """(the error of all tensors relative to the reference's whole norm, the
    largest error of one tensor relative to its own norm) of (got, reference,
    origin) triples; a tensor whose reference norm is under 1e-6 of the
    largest (a BatchNorm bias ahead of another BatchNorm, whose gradient is
    rounding noise) counts in the whole only."""
    err, base = {}, {}
    for k, (a, b, origin) in triples.items():
        err[k] = float((a.double() - b.double()).norm())
        base[k] = float((b.double() - origin.double()).norm())
    floor = 1e-6 * max(base.values())
    return (sum(e * e for e in err.values()) / sum(x * x for x in base.values())) ** 0.5, \
        max(err[k] / base[k] for k in base if base[k] > floor)


def mesh_against(ref, run):
    """``run`` (``mesh_steps``) against the one-process reference: the largest
    relative loss difference, the largest parameter or statistic difference,
    and the errors of the parameter updates and of the SGD slots (the
    gradient path, which a max-abs on the weights cannot see: each update is
    small beside the weights) by ``mesh_relative``."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
    state, slots = run["state"], run["slots"]
    return {"loss_rel": loss_rel,
            "param_max_abs_diff": max(amax(state[k].double() - ref["state"][k].double()) for k in ref["state"]),
            "update_rel": mesh_relative({k: (state[k], ref["state"][k], ref["init"][k]) for k in ref["init"]}),
            "slot_rel": mesh_relative({k: (slots[k], ref["slots"][k], torch.zeros(())) for k in ref["slots"]})}


def mesh_within(run) -> bool:
    """Whether a ``mesh_against`` record lies within the limits."""
    return (run["loss_rel"] <= MESH_LOSS_RTOL and run["param_max_abs_diff"] <= MESH_PARAM_ATOL
            and max(run["update_rel"][0], run["slot_rel"][0]) <= MESH_WHOLE_RTOL
            and max(run["update_rel"][1], run["slot_rel"][1]) <= MESH_TENSOR_RTOL)


def mesh_rank(rank, port, ref_path, out_path):
    """One of phase 6h (b)'s two ranks, sharing ``cuda:0`` over gloo: for each
    mesh of ``MESH_CASES`` the fp32 steps against the reference, then one bf16
    step as the preset trains, with its launches of the kernels."""
    from cenet_tpu_torch.core import mesh as M

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    M.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0", timeout_s=300)
    ref = torch.load(ref_path, weights_only=True)
    out = {}
    try:
        for name, (data, model) in MESH_CASES.items():
            mesh = M.make_mesh(M.MeshConfig(data=data, model=model), device="cuda:0")
            t0 = time.perf_counter()
            run = mesh_steps(mesh)
            against = mesh_against(ref, run)
            seconds = time.perf_counter() - t0
            tr = Trainer(mesh_config(True), 10, mesh=mesh)
            x, y = labelled_slices(31, TRAIN_B, 224)
            x, y = x[mesh.rows(TRAIN_B)].to(DEV), y[mesh.rows(TRAIN_B)].to(DEV)
            K.reset_launches()
            bf16_loss = float(tr.train_step(x, y))
            torch.cuda.synchronize()
            out[name] = {"losses": run["losses"], **against, "fp32_seconds": seconds, "bf16_loss": bf16_loss, "launches": dict(K.LAUNCHES),
                         "sharded_tensors": len(tr.tp_plan), "attn_impl": tr.cfg.model.attn_impl,
                         "rows": x.shape[0]}
            del tr
            torch.cuda.empty_cache()
    finally:
        M.shutdown_distributed()
    torch.save(out, out_path)


MESH_RANK = r"""
import sys
import chip_smoke
chip_smoke.mesh_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def phase_mesh(root):
    """6h: the ``('data', 'model')`` mesh (``core/mesh.py``) on the Synapse
    preset, TF32 off for the fp32 comparisons. The one-process reference
    takes two fp32 SGD steps; then (b) two ranks in fresh processes share the
    card over gloo with meshes (2, 1) and (1, 2), each held to the reference
    (losses to rtol 2e-4, weights and statistics to 5e-4 max-abs, updates and
    SGD slots by ``mesh_relative`` to 1e-3 and 1e-2) and each
    taking one bf16 step, whose launches of K1–K4 per rank must be the
    one-process step's (the sites route on the shape JAX sees: the global
    batch under data=2, the local heads 8/4/4 and the unsharded dec1 Nonlocal
    under model=2); meanwhile here (a) NCCL at one rank, mesh (1, 1), the same
    two steps under the same limits, and (c) ``cli train --mesh 1`` for one
    epoch of phase 6's slices and ``cli eval --mesh 1`` of its snapshot, whose
    JSON must equal ``cli eval`` without a mesh to 1e-6. Returns the launches
    of the ranks' bf16 steps, by mesh and rank."""
    from cenet_tpu_torch.core import mesh as M

    t_phase = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = mesh_steps()
        losses = ref["losses"]
        with tempfile.TemporaryDirectory() as tmp:
            ref_path = os.path.join(tmp, "ref.pt")
            torch.save(ref, ref_path)
            port = M.free_port()
            outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
            t_ranks = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-c", MESH_RANK, str(r), str(port), ref_path, outs[r]],
                                      cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True) for r in range(2)]
            try:
                # (a) NCCL at one rank, while the ranks run
                M.init_distributed(None, 1, 0, device=DEV)
                try:
                    mesh = M.make_mesh(M.MeshConfig(data=1, model=1), device=DEV)
                    nccl = mesh_against(ref, mesh_steps(mesh))
                    nccl["backend"] = torch.distributed.get_backend()
                finally:
                    M.shutdown_distributed()
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
                cli_result = mesh_cli(root)
                logs = []
                for p in procs:
                    logs.append(p.communicate(timeout=600)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            ranks_s = time.perf_counter() - t_ranks
            for r, (p, log) in enumerate(zip(procs, logs)):
                check(p.returncode == 0, f"mesh rank {r} failed (gloo on one card):\n{log[-4000:]}")
            ranks = [torch.load(o, weights_only=True) for o in outs]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want = TRAIN_PER_STEP["interleaved"]
    emit({"phase": "mesh", "reference_losses": losses, "nccl_one_rank": nccl, "ranks": ranks, "cli": cli_result,
          "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase, "per_step_one_process": want})
    check(nccl["backend"] == "nccl" and mesh_within(nccl), f"mesh (a), NCCL at one rank: {nccl}")
    launches = {}
    for name in MESH_CASES:
        for r, run in enumerate(rank[name] for rank in ranks):
            check(mesh_within(run), f"mesh (b) {name}, rank {r}, against one process: {run}")
            check(all(run["launches"].get(k, 0) == n for k, n in want.items())
                  and sum(run["launches"].values()) == sum(want.values()),
                  f"mesh (b) {name}, rank {r}: the bf16 step launched {run['launches']}, one process {want}")
            for k, n in run["launches"].items():
                launches.setdefault(k, {}).setdefault(name, [0, 0])[r] = n
    check(ranks[0]["model2"]["sharded_tensors"] > 0 and ranks[0]["model2"]["attn_impl"].endswith("@model"),
          f"mesh (b) model2 did not shard: {ranks[0]['model2']}")
    check(all(abs(cli_result["eval_mesh"][k] - cli_result["eval"][k]) <= 1e-6 for k in cli_result["eval"]),
          f"mesh (c): cli eval --mesh 1 {cli_result['eval_mesh']} against {cli_result['eval']}")
    return launches


def mesh_cli(root):
    """Phase 6h (c): ``cli train --mesh 1`` (one epoch, no snapshot eval) on
    phase 6's slices, then ``cli eval`` of its snapshot with ``--mesh 1`` and
    without, on one seeded 16 × 512² case in memory: both JSON lines, the
    launches of the train run, and the seconds."""
    import io

    from cenet_tpu_torch.cli import main as cli

    test_set = InMemoryVolumes([synthetic_case(23, d=16)])
    memo = MetricMemo()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["train", "--preset", "synapse", "--root_path", root, "--list_dir", root, "--output_dir", tmp,
                "--max_epochs", "1", "--eval_interval", "2", "--mesh", "1"]
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = cli.main(argv, test_set=InMemoryVolumes([]))
        out["train_s"], out["train_launches"], out["steps"] = time.perf_counter() - t0, dict(K.LAUNCHES), trainer.step
        del trainer
        torch.cuda.empty_cache()
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
        for key, extra in (("eval_mesh", ["--mesh", "1"]), ("eval", [])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), memo.installed():
                result = cli.main(["eval", "--preset", "synapse", "--checkpoint", snap, "--output_dir", tmp, *extra],
                                  test_set=test_set)
            out[key], out[f"{key}_s"] = result, time.perf_counter() - t0
            check(json.loads(buf.getvalue().strip().splitlines()[-1]) == result, f"cli {key}: printed {buf.getvalue()}")
    check(out["steps"] == 8 and all(out["train_launches"].get(k, 0) == 8 * n
                                     for k, n in TRAIN_PER_STEP["interleaved"].items()),
          f"mesh (c): cli train --mesh 1 took {out['steps']} steps, launched {out['train_launches']}")
    return out


# ---------------------------------------------------------------------------
# Phase 6i: the seq axis, ring attention on torch.distributed
# ---------------------------------------------------------------------------

RING_IMG, RING_B = 448, 2  # the inputs the ring exists for, at the batch that fits two ranks on one card
# CENet-b2 at 448²: DSEB1–3 (two rings each, 112², 56², 28² tokens), the four CFAM
# Nonlocals (dec1–dec4, 112² … 14²) and PVT stage 4's three SRA blocks (sr 1, 14²):
# 13 ring sites, 2 hops each on a seq axis of 2, per rank; no site left for K1/K3
RING_SITES_448 = 13
RING_PER_STEP = {"attention_fwd": 2 * RING_SITES_448, "attention_bwd": 2 * RING_SITES_448}
# at 224² (the eval chunk) dec4 and PVT stage 4 have 7² = 49 tokens, odd: they take
# the plain fallback, so 9 ring sites, 18 K2 a chunk on each rank
RING_PER_CHUNK = {"attention_fwd": 2 * 9}
# the one-process step at 448², batch 2 ('pallas'): K1/K3 at DSEB1–3, K2/K4 at dec1
# and dec2 (dec3's 784² map is under the router's 32 MB)
ONE_PROCESS_448 = {"diff_attention_interleaved_fwd": 3, "diff_attention_interleaved_bwd": 3, "attention_fwd": 2,
                   "attention_bwd": 2}
# (a)'s sites at 448²: (site, h, n, d, dv) of the ring core alone
RING_SITES = [("dec1", 1, 12544, 64, 64), ("DSEB1", 8, 12544, 8, 16)]


def ring_config(amp, impl):
    """The Synapse preset at 448² with ``attn_impl`` ``impl``, bf16 (``amp``) or fp32."""
    base = get_preset("synapse")
    return base.replace(model=dataclasses.replace(base.model, attn_impl=impl),
                        data=dataclasses.replace(base.data, img_size=RING_IMG),
                        train=dataclasses.replace(base.train, amp=amp))


def ring_steps(mesh=None, impl="pallas"):
    """``MESH_STEPS`` fp32 steps at 448², batch 2 (``mesh_steps``' record), the
    preset's seed; on ``mesh`` with ``impl``, or in one process."""
    x, y = labelled_slices(37, RING_B, RING_IMG)
    tr = Trainer(ring_config(False, impl), 10, device=DEV if mesh is None else mesh.device, mesh=mesh)
    init = {k: v.detach().cpu().clone() for k, v in tr.state_dict()["state_dict"].items()}
    x, y = x.to(tr.device), y.to(tr.device)
    losses = [float(tr.train_step(x, y)) for _ in range(MESH_STEPS)]
    full = tr.state_dict()
    slots = {n: s["trace"].cpu() for n, s in full["optimizer"]["state"].items()}
    return {"losses": losses, "state": {k: v.cpu() for k, v in full["state_dict"].items()}, "slots": slots,
            "init": {k: init[k] for k in slots}, "trainer": tr}


def ring_bf16_step(mesh=None, impl="pallas"):
    """One bf16 step of the preset at 448², batch 2: loss, launches, peak memory (GB)."""
    x, y = labelled_slices(37, RING_B, RING_IMG)
    tr = Trainer(ring_config(True, impl), 10, device=DEV if mesh is None else mesh.device, mesh=mesh)
    x, y = x.to(DEV), y.to(DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    loss = float(tr.train_step(x, y))
    torch.cuda.synchronize()
    out = {"loss": loss, "launches": dict(K.LAUNCHES), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr
    torch.cuda.empty_cache()
    return out


def ring_grads_check(call, got, idx, where):
    """Gradients ``got`` (those of ``idx`` among dq, dk, dv) of the ring against
    K4's twin on ``call`` = (q, k, v, o, lse, dO), under ``grad_limits``."""
    want, want_r = bwd_refs("attention_bwd", call)
    names = [("dq", "dk", "dv")[i] for i in idx]
    lims = grad_limits(call[0].dtype, [want[i] for i in idx], [want_r[i] for i in idx])
    out = {}
    for name, g, i, (lim, nlim) in zip(names, got, idx, lims):
        e, ne = amax(g.float() - want[i]), rel_norm(g, want[i])
        out.update({f"{name}_err": e, f"{name}_limit": lim, f"{name}_norm_err": ne, f"{name}_norm_limit": nlim})
        check(g.dtype == call[0].dtype and e <= lim and ne <= nlim,
              f"ring at {where}: {name} err {e} (limit {lim}), norm err {ne} (limit {nlim})")
    return out


def ring_core_checks(mesh):
    """Phase 6i (a) on one rank: the ring core's forward and backward (``ring_forward``,
    ``ring_backward``: K2 and K4 on every hop) on this rank's token block at
    dec1's and DSEB1's 448² shapes, batch 2, fp32 and bf16, held against the
    kernels' twins on the same inputs: o and the LSE of the block's query rows
    (``fwd_check``), dq of those rows against the twin on them, dk and dv of the
    block's keys against the twin over every query row with the gathered O and
    LSE (``ring_grads_check``); per batch row. Two hops of each kernel."""
    from cenet_tpu_torch.ops import ring_attention as RA

    out = {}
    for site, h, n, d, dv in RING_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=DEV).manual_seed(n + d)
            q, k, v = site_inputs("attention_fwd", RING_B, h, n, d, dv, dtype, gen)
            do = torch.randn(RING_B, h, n, dv, generator=gen, device=DEV).to(dtype)
            blk = slice(mesh.s * n // mesh.seq, (mesh.s + 1) * n // mesh.seq)
            qb, kb, vb, dob = (t[:, :, blk] for t in (q, k, v, do))
            K.reset_launches()
            ob, lseb = RA.ring_forward(qb, kb, vb, mesh)
            grads = RA.ring_backward(qb, kb, vb, ob, lseb, dob, mesh)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            o, lse = (M.gather_cat(t, mesh.seq_group, mesh.seq, dim=2) for t in (ob, lseb))
            where = f"{site} {str(dtype)[6:]} rank {mesh.s}"
            rec = {"launches": launches,
                   **in_slices(fwd_check, "attention_fwd", [qb, k, v], [ob, lseb], where, step=1),
                   **in_slices(lambda _, a, g, w: ring_grads_check(a, g, (0,), w), "attention_bwd",
                               [qb, k, v, ob, lseb, dob], [grads[0]], where, step=1),
                   **in_slices(lambda _, a, g, w: ring_grads_check(a, g, (1, 2), w), "attention_bwd",
                               [q, kb, vb, o, lse, do], list(grads[1:]), where, step=1)}
            check_launches(launches, {"attention_fwd": mesh.seq, "attention_bwd": mesh.seq}, 1, f"ring core at {where}")
            out[where] = rec
            del q, k, v, do, grads, o, lse
            torch.cuda.empty_cache()
    return out


def ring_rank(rank, port, out_path):
    """One of phase 6i's two ranks of the (1, 1, 2) mesh, sharing ``cuda:0`` over
    gloo: (a) the ring core alone, (b) two fp32 steps of the preset at 448²
    with ``attn_impl='ring'`` (the record that ``mesh_against`` holds to the
    one-process steps) and whether the seq ranks' weights (and BatchNorm
    statistics) agree to the bit after them, (c) one bf16 step with its
    launches and peak memory; then rank 0 alone takes the one-process steps
    (two fp32 with K1–K4 routed, one bf16), which (b) and (c) are held to,
    and (e) one bf16 step with ``attn_impl='ring'`` and no mesh registered
    (every ring site falls back: its kernels must be the routed ones)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    M.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0", timeout_s=600)
    out = {}
    try:
        mesh = M.make_mesh(M.MeshConfig(data=1, model=1, seq=2), device="cuda:0")
        M.set_attention_mesh(mesh)
        t0 = time.perf_counter()
        out["core"] = ring_core_checks(mesh)
        out["core_s"] = time.perf_counter() - t0
        M.set_attention_mesh(None)
        t0 = time.perf_counter()
        run = ring_steps(mesh, "ring")
        tr = run.pop("trainer")
        with torch.no_grad():
            params = torch.cat([p.detach().double().reshape(-1) for p in tr.model.parameters()])
            buffers = torch.cat([b.detach().double().reshape(-1) for b in tr.model.buffers()])
        out["fp32"] = {"run": run, "seconds": time.perf_counter() - t0, "impl": tr.cfg.model.attn_impl,
                       "weights_agree": M.agree(params, mesh.seq_group),
                       "statistics_agree": M.agree(buffers, mesh.seq_group)}
        del tr
        torch.cuda.empty_cache()
        out["bf16"] = ring_bf16_step(mesh, "ring")
    finally:
        M.shutdown_distributed()
    if rank == 0:  # the one-process steps, on the same card once the ranks are done
        ref = ring_steps()
        del ref["trainer"]
        torch.cuda.empty_cache()
        out["one"] = {"ref": ref, "bf16": ring_bf16_step(), "ring_off_mesh": ring_bf16_step(impl="ring")}
    torch.save(out, out_path)


RING_RANK = r"""
import sys
import chip_smoke
chip_smoke.ring_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
"""


def ring_eval_rank(rank, port, pth, out_dir, cases, memo=None):
    """Phase 6i (d) on one rank: ``cli eval --mesh 1,1,2 --attn_impl ring`` of
    ``pth`` over ``cases`` in memory, its mode function (``cli.run_eval``) on
    the mesh that its parsed ``--mesh`` names, this process joined to the
    two-rank group over gloo at ``port`` (the CLI's own launcher would take
    NCCL, one card a rank). Returns the labels of each case, the launches and
    the result (rank 0 computes the metrics, through ``memo`` when given)."""
    from cenet_tpu_torch.cli import main as cli

    argv = ["eval", "--preset", "synapse", "--checkpoint", pth, "--output_dir", out_dir, "--mesh", "1,1,2",
            "--attn_impl", "ring"]
    args = cli.build_argparser().parse_args(argv)
    M.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=DEV, timeout_s=600)
    labels, predict = [], VOL.VolumeInferencer.predict_volume

    def recorded(self, image):
        labels.append(predict(self, image))
        return labels[-1]

    VOL.VolumeInferencer.predict_volume = recorded
    try:
        mesh = M.make_mesh(cli._mesh_config(args), device=DEV)
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), (memo.installed() if memo else contextlib.nullcontext()):
            result = cli.run_eval(cli.make_config(args), args, test_set=InMemoryVolumes(cases), mesh=mesh)
        seconds = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        VOL.VolumeInferencer.predict_volume = predict
        M.shutdown_distributed()
    return {"labels": labels, "launches": launches, "result": result, "seconds": seconds, "seq": mesh.seq}


RING_EVAL_RANK = r"""
import sys
import numpy as np
import torch
import chip_smoke
out = chip_smoke.ring_eval_rank(1, int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                [chip_smoke.synthetic_case(1), chip_smoke.synthetic_case(2)])
torch.save({"labels": [np.asarray(x) for x in out["labels"]], "launches": out["launches"]}, sys.argv[4])
"""


def start_ring_eval(tmp):
    """Phase 6i (d)'s rank 1 in a fresh process, on phase 4's weights saved in
    ``tmp``: (the process, the port, the checkpoint, where it writes its labels)."""
    pth = os.path.join(tmp, "cenet_b2.pth")
    torch.save(build_model(get_preset("synapse"), device=DEV, seed=0).state_dict(), pth)  # phase 4's weights
    port, out = M.free_port(), os.path.join(tmp, "eval_rank1.pt")
    child = subprocess.Popen([sys.executable, "-c", RING_EVAL_RANK, str(port), pth, os.path.join(tmp, "out1"), out],
                             cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    return child, port, pth, out


def phase_ring(volume):
    """6i: the ``seq`` axis (``core/mesh.py``) and ring attention
    (``ops/ring_attention.py``) on the Synapse preset at 448², batch 2, TF32 off
    for the fp32 comparisons. Two ranks in fresh processes share the card over
    gloo with the mesh (1, 1, 2) and ``attn_impl='ring'``: (a) the ring core
    alone at dec1's and DSEB1's shapes against the kernels' twins (fp32 and
    bf16 limits of phases 2, 2b), (b) two fp32 steps held to the one-process
    steps ('pallas': K1–K4 routed, which rank 0 takes after the mesh's) under
    phase 6h's limits, the seq ranks' weights equal to the bit after them,
    (c) one bf16 step whose K2/K4 launches a rank must be ``RING_PER_STEP``
    and nothing else (no K1/K3 at a ringed site), its peak memory beside the
    one-process step's. Meanwhile here (d) ``cli eval --mesh 1,1,2
    --attn_impl ring`` over phase 4's cases at 224², this process rank 0
    (``ring_eval_rank``) and a fresh one rank 1: labels agreeing with
    phase 4's (``cli eval`` without a mesh, phase 4d) on ≥ 99.9% of voxels,
    equal on both ranks, K2 launched ``RING_PER_CHUNK`` a chunk. Last (e)
    ``attn_impl='ring'`` in one process without a mesh: the fallback keeps the
    kernels, so its bf16 step launches the one-process step's K1–K4
    (``ONE_PROCESS_448``) and its loss is that step's within 2·2^-8. Returns
    the launches: the ranks' bf16 step and eval run, by rank."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port = M.free_port()
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, "-c", RING_RANK, str(r), str(port), outs[r]],
                                  cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        child, eval_port, pth, child_out = start_ring_eval(tmp)
        try:
            memo = volume["metrics"]
            memo.misses = 0
            t_eval = time.perf_counter()
            lead = ring_eval_rank(0, eval_port, pth, os.path.join(tmp, "out0"), volume["cases"], memo)
            eval_s = time.perf_counter() - t_eval
            logs = [p.communicate(timeout=900)[0] for p in (child, *procs)]
        finally:
            for p in (child, *procs):
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for name, p, log in zip(("eval rank 1", "rank 0", "rank 1"), (child, *procs), logs):
            check(p.returncode == 0, f"ring {name} failed (gloo on one card):\n{log[-4000:]}")
        other = torch.load(child_out, weights_only=False)
        ranks = [torch.load(o, weights_only=True) for o in outs]
    ref, off_mesh = ranks[0]["one"]["ref"], ranks[0]["one"]["ring_off_mesh"]
    one = ranks[0].pop("one")["bf16"]
    for run in ranks:
        run["fp32"].update(mesh_against(ref, run["fp32"].pop("run")))
    preds = [volume["preds"][c["case_name"]] for c in volume["cases"]]
    agree = agreement(lead["labels"], preds)
    chunks = sum(-(-c["image"].shape[0] // CHUNK) for c in volume["cases"])
    emit({"phase": "ring", "reference_losses": ref["losses"], "one_process_bf16": one, "ranks": ranks,
          "eval": {"result": lead["result"], "label_agree_vs_phase_4": agree, "launches": [lead["launches"],
                   other["launches"]], "seconds": lead["seconds"], "metric_misses": memo.misses},
          "eval_s": eval_s, "seconds": time.perf_counter() - t_phase,
          "ranks_peak_mem_gb": [r["bf16"]["peak_mem_gb"] for r in ranks],
          "one_process_peak_mem_gb": one["peak_mem_gb"], "ring_off_mesh_bf16": off_mesh})
    check_launches(one["launches"], ONE_PROCESS_448, 1, "ring: the one-process bf16 step at 448²")
    check_launches(off_mesh["launches"], ONE_PROCESS_448, 1, "ring (e): 'ring' without a mesh, bf16 step at 448²")
    check(abs(off_mesh["loss"] - one["loss"]) <= 2 * 2 ** -8 * abs(one["loss"]),
          f"ring (e): loss {off_mesh['loss']} against the one-process step's {one['loss']}")
    for r, run in enumerate(ranks):
        check(mesh_within(run["fp32"]) and run["fp32"]["impl"] == "ring",
              f"ring (b), rank {r}, against one process: {run['fp32']}")
        check(run["fp32"]["weights_agree"], "ring (b): the seq ranks' weights differ after the steps")
        check(run["fp32"]["statistics_agree"], "ring (b): the seq ranks' BatchNorm statistics differ after the steps")
        check_launches(run["bf16"]["launches"], RING_PER_STEP, 1, f"ring (c), rank {r}'s bf16 step")
        check(np.isfinite(run["bf16"]["loss"]), f"ring (c), rank {r}: loss {run['bf16']['loss']}")
    check(sum(r["bf16"]["peak_mem_gb"] for r in ranks) <= 80.0, "ring (c): the two ranks exceed the card's 80 GB")
    for r, got in enumerate((lead["launches"], other["launches"])):
        check_launches(got, RING_PER_CHUNK, chunks, f"ring (d), rank {r}'s cli eval, {chunks} chunks")
    check(lead["seq"] == 2 and agree >= 0.999, f"ring (d): labels agree with phase 4's on {agree}")
    check(all(np.array_equal(a, b) for a, b in zip(lead["labels"], other["labels"])),
          "ring (d): the two ranks' labels differ")
    launches = {}
    for tag, per_rank in (("step", [r["bf16"]["launches"] for r in ranks]),
                          ("eval", [lead["launches"], other["launches"]])):
        for r, got in enumerate(per_rank):
            for k, n in got.items():
                launches.setdefault(k, {}).setdefault(tag, [0, 0])[r] = n
    return launches


# ---------------------------------------------------------------------------
# Phase 6g: remat, --model_stats, the profiler hook, debug, device augmentation
# ---------------------------------------------------------------------------

# per train step with ``train.remat`` on the swapped route: the recompute runs
# the forward of each of b2's 16 PVT blocks again, so its DWConv's K11 forward
# (86 = 35 forwards + 35 dx + 16 recomputed); the routed sites lie outside the
# PVT blocks, so K1–K4 launch as without remat
TRAIN_PER_STEP["swapped, remat"] = {**TRAIN_PER_STEP["swapped"], "depthwise_fwd": 86}
# the tensor-core kernels of K1–K4 that a bf16 step's trace must name
TRACE_DESIGNS = ("fwd_tc", "bwd_dq_tc", "bwd_dkv_tc", "diff_fwd_tc", "diff_bwd_dq_tc", "diff_bwd_dkv_tc")


def remat_config(remat):
    """The Synapse preset as it stands (CENet-b2, 224², batch 8, bf16,
    drop-path 0.1), with ``train.remat`` on or off."""
    base = get_preset("synapse")
    return base.replace(train=dataclasses.replace(base.train, remat=remat))


def remat_against_plain(steps=2):
    """``steps`` train steps at batch 8 with ``train.remat`` and without, from
    the same seeded weights on the same batch (the trainer reseeds its
    drop-path generator from the step count): each run's losses and launch
    counts, and ``compare_states`` of the two final states."""
    x, y = labelled_slices(7, TRAIN_B, 224)
    x, y = x.to(DEV), y.to(DEV)
    runs, trainers = {}, []
    for remat in (False, True):
        trainer = Trainer(remat_config(remat), max_iterations=100, device=DEV, model_seed=0)
        K.reset_launches()
        losses = [trainer.train_step(x, y) for _ in range(steps)]
        torch.cuda.synchronize()
        runs["remat" if remat else "plain"] = {"losses": torch.stack(losses).cpu().tolist(),
                                               "launches": dict(K.LAUNCHES)}
        trainers.append(trainer)
    return {**runs, **compare_states(*trainers),
            "losses_equal": runs["plain"]["losses"] == runs["remat"]["losses"]}


# phase 6g's remat check in a fresh process under phase 6b's determinism
# settings (CUBLAS_WORKSPACE_CONFIG before the process first touches cuBLAS)
REMAT_AGAINST_PLAIN = r"""
import json, os
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True)
import chip_smoke
print(json.dumps(chip_smoke.remat_against_plain()))
"""


def trace_designs(path):
    """Kernel events of a Chrome trace by ``KERNEL_DESIGNS``' patterns."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    return {d: sum(bool(re.search(pat, n)) for n in names) for d, pat in KERNEL_DESIGNS.items()}


def hooked_trace(trainer, images, labels, tries=3):
    """``ProfilerHook`` over steps 1 and 2 of four: the trace's path, its kernel
    events by design, and the try that named every design of
    ``TRACE_DESIGNS`` (a session now and then loses kernel records, so up to
    ``tries`` sessions, as ``profiled_kernels``)."""
    from cenet_tpu_torch.core.logging_utils import ProfilerHook

    with tempfile.TemporaryDirectory() as out:
        for attempt in range(1, tries + 1):
            hook = ProfilerHook(os.path.join(out, f"try{attempt}"), start_step=1, num_steps=2)
            for step in range(4):
                hook.maybe_start_stop(step)
                trainer.train_step(images, labels)
            torch.cuda.synchronize()
            designs = trace_designs(hook.trace_path)
            if all(designs[d] > 0 for d in TRACE_DESIGNS):
                break
        return {"trace": os.path.basename(hook.trace_path), "bytes": os.path.getsize(hook.trace_path),
                "try": attempt, "designs": {d: n for d, n in designs.items() if n}}


def model_stats_cli(root):
    """``cli train --preset synapse --model_stats`` in-process on phase 6's
    slices for one epoch (8 steps, no snapshot eval): its launch counts, its
    stats line, ``model_cost`` of its trainer's model on the card and of the
    same model built on the CPU, and what ``FlopCounterMode`` reads of the
    card's forward at (1, 1, 224, 224) with the sites routed as the card
    routes them, and with every site under the router's limit."""
    from torch.utils.flop_counter import FlopCounterMode

    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core.stats import model_cost

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["train", "--preset", "synapse", "--root_path", root, "--list_dir", root, "--output_dir", tmp,
                "--max_epochs", "1", "--eval_interval", "2", "--model_stats"]
        out = io.StringIO()
        K.reset_launches()
        with contextlib.redirect_stdout(out):
            trainer = cli.main(argv, test_set=InMemoryVolumes([]))
        launches, steps = dict(K.LAUNCHES), trainer.step
    line = [ln.split("] ", 1)[-1] for ln in out.getvalue().splitlines() if "GFLOPs" in ln]
    shape = (1, 1, 224, 224)
    card = model_cost(trainer.model, shape)
    cpu = model_cost(build_model(get_preset("synapse"), device="cpu", seed=0), shape)
    want = (f"model: {cpu['params_m']:.2f} M params, {cpu['flops_g']:.2f} GFLOPs @ {shape}, "
            f"{cpu['bytes_accessed_gb']:.2f} GB accessed")
    model = trainer.model.eval()
    naive = {}
    for name, limit in (("routed", router._SMALL_LIMIT), ("plain", 1 << 62)):
        saved, router._SMALL_LIMIT = router._SMALL_LIMIT, limit
        try:
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                model(torch.zeros(shape, device=DEV))
        finally:
            router._SMALL_LIMIT = saved
        naive[name] = fc.get_total_flops() / 1e9
    return {"steps": steps, "launches": launches, "line": line, "want": want, "card": card, "cpu": cpu,
            "naive_aten_gflops_on_card": naive, "naive_gap_gflops": naive["plain"] - naive["routed"]}


def device_augment_check(train_wait_ms, n=8, size=512, out_size=224, reps=20):
    """``data/device_augment.py`` on the card: ``n`` raw seeded ``size``²
    slices in, an ``out_size``² batch out; the card's transform against the
    CPU's for the same per-sample choices (labels equal, images within 1e-5 of
    max |x|); img/s of ``random_generator_batch`` by CUDA events beside the
    host path's (``data/augment.py::random_generator`` on the same slices,
    one at a time, by the host's clock) and phase 6's loader wait."""
    from cenet_tpu_torch.data import device_augment as DA

    x, y = labelled_slices(11, n, size)
    xd, yd = x.to(DEV), y.to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    choices = DA.draw_choices(gen, n)
    img, lab = DA.apply_choices(xd, yd, choices, out_size)
    want_img, want_lab = DA.apply_choices(x, y, {k: v.cpu() for k, v in choices.items()}, out_size)
    img_err = amax(img.cpu() - want_img) / max(amax(want_img), 1e-30)
    labels_equal = torch.equal(lab.cpu(), want_lab)
    branches = {"rot_flip": int((choices["u1"] > 0.5).sum()),
                "rotate": int(((choices["u1"] <= 0.5) & (choices["u2"] > 0.5)).sum())}
    got = DA.random_generator_batch(gen, xd, yd, out_size)
    card_ms = time_ms(lambda: DA.random_generator_batch(gen, xd, yd, out_size), reps=reps)
    rng = np.random.default_rng(0)
    images, labels = x[:, 0].numpy(), y.numpy()
    augment.random_generator(images[0], labels[0], out_size, rng)
    t0 = time.perf_counter()
    for i in range(n):
        augment.random_generator(images[i], labels[i], out_size, rng)
    host_s = time.perf_counter() - t0
    return {"batch": n, "in": size, "out": out_size, "shapes": [list(t.shape) for t in got],
            "dtypes": [str(t.dtype) for t in got], "branches_of_checked_batch": branches,
            "image_err_vs_cpu": img_err, "labels_equal_cpu": labels_equal, "card_ms_per_batch": card_ms,
            "card_img_per_s": n / card_ms * 1e3, "host_img_per_s": n / host_s,
            "phase6_loader_wait_ms_per_step": train_wait_ms}


def phase_remat(root, train_wait_ms):
    """6g: the one-card training surface of this slice on the card at full
    width (the Synapse preset, CENet-b2, 224², batch 8, bf16, seeded weights,
    interleaved route):

    - two steps with ``train.remat`` against two without, from the same state
      and generator seed at drop-path 0.1, in a fresh process under phase 6b's
      determinism settings: losses and every tensor of the final states equal
      to the bit;
    - a step of each in this process: K1–K4 launched as without remat, peak
      memory (``max_memory_allocated``, reset before each), step ms (CUDA
      events, 5 steps after the measured one), and one profiled step's busy
      device ms, kernel launches and host operators (``profile_step``);
    - the remat step on the swapped route (``swapped_ops``): 86 K11 forwards,
      the rest as phase 7c's step;
    - ``ProfilerHook`` over two remat steps: a trace naming K1–K4's
      tensor-core kernels;
    - ``assert_finite`` and ``tree_norm`` of the trained state;
    - ``cli train --model_stats``: its stats line equal to ``model_cost`` of
      the same model on the CPU, and the card's count equal to the CPU's, the
      naive aten count on the card beside it;
    - ``device_augment_check``.

    Returns the launch counts of the remat step (the interleaved route)."""
    from cenet_tpu_torch.core.debug import assert_finite, tree_norm

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", REMAT_AGAINST_PLAIN], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the remat process failed:\n{proc.stderr[-3000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    fresh["process_s"] = time.perf_counter() - t0
    x, y = labelled_slices(7, TRAIN_B, 224)
    x, y = x.to(DEV), y.to(DEV)
    runs = {}
    for remat in (False, True):
        trainer = Trainer(remat_config(remat), max_iterations=100, device=DEV, model_seed=0)
        trainer.train_step(x, y)  # cuDNN plans, optimizer state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        loss = trainer.train_step(x, y)
        torch.cuda.synchronize()
        runs[remat] = {"launches": dict(K.LAUNCHES), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "loss": float(loss), "step_ms": time_ms(lambda: trainer.train_step(x, y), reps=5)}
        prof = profile_step(trainer, x, y)  # where the step's time goes: the host or the card
        runs[remat]["profile"] = {k: prof[k] for k in ("step_wall_ms_profiled", "device_busy_ms", "device_idle_share",
                                                       "kernel_launches", "host_ops", "host_self_ms")}
        if not remat:
            del trainer
            torch.cuda.empty_cache()
    with swapped_ops():
        trainer.train_step(x, y)
        binding.reset_launches()
        trainer.train_step(x, y)
        torch.cuda.synchronize()
        swapped = dict(binding.LAUNCHES)
    seconds = {"fresh_process": fresh["process_s"], "steps": time.perf_counter() - t0 - fresh["process_s"]}
    t0 = time.perf_counter()
    hooked = hooked_trace(trainer, x, y)
    seconds["profiler_hook"] = time.perf_counter() - t0
    state = trainer.state_dict()
    assert_finite(state, "the remat trainer's state")
    norms = {"params": tree_norm(dict(trainer.model.named_parameters())), "momentum": tree_norm(trainer.optimizer.state)}
    del trainer, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats = model_stats_cli(root)
    seconds["model_stats"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    augment_row = device_augment_check(train_wait_ms)
    seconds["device_augment"] = time.perf_counter() - t0
    plain, remat = runs[False], runs[True]
    emit({"phase": "remat", "fresh_process": fresh,
          "plain": plain, "remat": remat,
          "peak_mem_ratio": remat["peak_mem_gb"] / plain["peak_mem_gb"],
          "step_ms_ratio": remat["step_ms"] / plain["step_ms"],
          "swapped_remat_launches": swapped, "profiler_hook": hooked, "tree_norm": norms,
          "seconds": seconds, "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "model_stats", **stats})
    emit({"phase": "device_augment", **augment_row})
    check(fresh["losses_equal"] and fresh["unequal"] == 0 and fresh["tensors"][0] == fresh["tensors"][1],
          f"remat against no remat: {fresh}")
    check(fresh["plain"]["launches"] == fresh["remat"]["launches"],
          f"remat launches {fresh['remat']['launches']} against {fresh['plain']['launches']}")
    for on, run in runs.items():
        check_launches(run["launches"], TRAIN_PER_STEP["interleaved"], 1, f"train step, remat={on}")
        check(np.isfinite(run["loss"]), f"train step, remat={on}: loss {run['loss']}")
    check_launches(swapped, TRAIN_PER_STEP["swapped, remat"], 1, "swapped remat step")
    check(all(hooked["designs"].get(d, 0) > 0 for d in TRACE_DESIGNS),
          f"ProfilerHook's trace lacks a tensor-core kernel of K1–K4: {hooked}")
    check(np.isfinite(norms["params"]) and norms["params"] > 0, f"tree_norm {norms}")
    check(stats["line"] == [stats["want"]], f"--model_stats logged {stats['line']}, the CPU's count {stats['want']}")
    check(stats["card"] == stats["cpu"], f"model_cost on the card {stats['card']}, on the CPU {stats['cpu']}")
    check(stats["naive_aten_gflops_on_card"]["plain"] == stats["cpu"]["flops_g"],
          f"the unrouted aten count {stats['naive_aten_gflops_on_card']} is not model_cost's {stats['cpu']}")
    check_launches(stats["launches"], TRAIN_PER_STEP["interleaved"], stats["steps"], "cli train --model_stats")
    check(stats["steps"] == 64 // TRAIN_B, f"cli train --model_stats took {stats['steps']} steps")
    check(augment_row["labels_equal_cpu"] and augment_row["image_err_vs_cpu"] <= 1e-5,
          f"device augmentation on the card against the CPU: {augment_row}")
    check(augment_row["shapes"] == [[TRAIN_B, 1, 224, 224], [TRAIN_B, 224, 224]], f"device augmentation {augment_row}")
    return remat["launches"]


# K10 calls profiled in a fresh process (``k10_calls_profiled``); its last line is
# the CUDA kernels of the first session that ``alone`` accepts, or of the last
K10_CALLS_PROFILED = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from cenet_tpu_torch.ops import rotary as ROT
saved = torch.load(sys.argv[1])
qd, cos, sin = (saved[k].cuda() for k in ("qd", "cos", "sin"))
calls, tries = int(sys.argv[2]), int(sys.argv[3])
ROT.apply_rotary_emb_kernel(qd, cos, sin)  # load the library outside the sessions
for _ in range(tries):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ROT.apply_rotary_emb_kernel(qd, cos, sin)
        torch.cuda.synchronize()
    kernels = [[e.key, e.count] for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if 1 <= sum(n for _, n in kernels) <= calls and all("rotary_vec_kernel<" in k for k, _ in kernels):
        break
print(json.dumps(kernels))
"""


def k10_calls_profiled(qd, cos, sin, calls, tries=3):
    """The CUDA kernels (key, count) of ``calls`` K10 calls on ``qd`` with the
    tables ``cos``, ``sin``, profiled in a fresh process on the libraries built
    here, up to ``tries`` sessions while they are not K10's kernel alone. In this long
    process such a session, which holds only the ctypes-launched K10 kernels,
    came back empty in all three tries of two whole runs on an H100, while
    the forward profile just before it held K10 twice; in a fresh process it
    held all four launches (PERF.md §7)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k10_inputs.pt")
        torch.save({"qd": qd.cpu(), "cos": cos.cpu(), "sin": sin.cpu()}, path)
        out = subprocess.run([sys.executable, "-c", K10_CALLS_PROFILED, path, str(calls), str(tries)],
                             cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                             timeout=600)
    check(out.returncode == 0, f"the K10 profile process failed:\n{out.stderr[-3000:]}")
    kernels = [types.SimpleNamespace(key=k, count=n) for k, n in json.loads(out.stdout.strip().splitlines()[-1])]
    return kernels


def phase_rotary(n=3136):
    """``MultiheadDiffAttn(use_rotary=True)`` at DSEB1's width (128 channels, 8
    heads of head dim 8, 3136 tokens), batch 8, in inference, with rel_pos =
    ``make_rotary_tables(3136, 8)``: the swapped module (K10 for the
    interleaved rotary of q and k) against the plain one, fp32 within 1e-6 of
    max |out| and bf16 within 2·2^-8 (K10 rounds every product and sum in x's
    dtype, as the plain rotary does, so both read 0 unless the card's K1 or K9
    differ between the runs); the K10 composition on the module's own q and k
    against the plain rotary, within those limits and equal to the bit; the bf16
    forward's kernels by design from ``torch.profiler`` (K10's vectorised kernel
    twice, K1 once) and four K10 calls on the fp32 tables, which must launch its
    kernel alone (the tables are rounded in the kernel, not cast first); K10
    timed on q (CUDA events, and device time by ``graph_ms``) against its twin.
    K10 runs before the plain module and rotary on the same inputs, so its
    outputs cannot pass by landing in a buffer that holds the plain result.
    Returns the bf16 run's launch counts and the kernel's row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    e, heads = 128, 8
    hd = e // heads // 2
    torch.manual_seed(12)
    module = MultiheadDiffAttn(e, depth=2, num_heads=heads, attn_impl="pallas", use_rotary=True).to(DEV).eval()
    module.reset_parameters(torch.Generator(device=DEV).manual_seed(12))
    cos, sin = ROT.make_rotary_tables(n, hd, device=DEV)
    x = torch.randn(TRAIN_B, n, e, generator=torch.Generator(device=DEV).manual_seed(13), device=DEV)
    row = {"kernel": "rotary", "site": [TRAIN_B, 2 * heads, n, hd]}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xd = x.to(dtype)
        # K10's runs before the plain ones: no buffer that K10's output lands in
        # can hold a plain result on the same inputs
        with torch.inference_mode():
            binding.reset_launches()
            with swapped_ops():
                swapped = module(xd, (cos, sin))
            torch.cuda.synchronize()
            launched = dict(binding.LAUNCHES)
            q = module.q_proj(xd).reshape(TRAIN_B, n, 2 * heads, hd).transpose(1, 2)
            k = module.k_proj(xd).reshape(TRAIN_B, n, 2 * heads, hd).transpose(1, 2)
            with swapped_ops():
                qk = [ROT.apply_rotary_emb(t, cos, sin, interleaved=True) for t in (q, k)]
            plain = module(xd, (cos, sin))
            qk_plain = [ROT.apply_rotary_emb(t, cos, sin, interleaved=True) for t in (q, k)]
        check_launches(launched, ROTARY_PER_FORWARD, 1, f"rotary path ({dname})")
        tol = 1e-6 if dtype == torch.float32 else 2 * BF16_REL
        err, lim = amax(swapped.float() - plain.float()), tol * amax(plain)
        check(err <= lim, f"rotary path ({dname}): swapped module off the plain one by {err} (limit {lim})")
        row.update({f"{dname}_module_err": err, f"{dname}_module_limit": lim, f"{dname}_launches": launched})
        for name, got, want in zip("qk", qk, qk_plain):
            row.update({f"{dname}_{name}_{kk}": v for kk, v in close_check(got, want, dtype, f"rotary {name} {dname}",
                                                                          fp32_tol=1e-6).items()})
            row[f"{dname}_{name}_bit_equal"] = bool(torch.equal(got, want))
            check(row[f"{dname}_{name}_bit_equal"], f"rotary {name} {dname}: K10 differs from the plain rotary")
    # the bf16 forward's kernels by design: K10's vectorised kernel twice (q, k),
    # K1 once; and K10 calls on fp32 tables: its kernel alone, no table cast
    want = expected_designs(ROTARY_PER_FORWARD)

    def by_design(kernels):
        return {r: d["calls"] for r, d in kernel_designs(kernels).items()}

    # a session of one K10 call lost its only kernel record twice running (PERF.md
    # §7): four calls, of which the profile must hold K10's kernel and no other
    calls = 4

    def alone(kernels):
        return 1 <= sum(e.count for e in kernels) <= calls and all("rotary_vec_kernel<" in e.key for e in kernels)

    qd = ROT.deinterleave(q)
    with torch.inference_mode(), swapped_ops():
        forward = profiled_kernels(lambda: module(xd, (cos, sin)),
                                   lambda ks: all(by_design(ks)[r] == want[r] for r in KERNEL_DESIGNS))
    call = k10_calls_profiled(qd, cos, sin, calls)
    row.update({"bf16_kernel_designs": by_design(forward), "bf16_call_kernels": {e.key[:80]: e.count for e in call}})
    check_designs(kernel_designs(forward), ROTARY_PER_FORWARD, "rotary bf16 forward profile")
    check(alone(call), f"{calls} K10 calls on fp32 tables launched {row['bf16_call_kernels']}, expected its kernel "
                       "alone")
    row["ms"] = time_ms(lambda: ROT.apply_rotary_emb_kernel(qd, cos, sin))
    # device time: a CUDA graph of calls on copies of q that pass twice the L2
    row["device_ms"] = graph_ms(lambda t: ROT.apply_rotary_emb_kernel(t, cos, sin), rotated((qd,)))
    row["plain_ms"] = time_ms(lambda: ROT.apply_rotary_emb_kernel_plain(qd, cos, sin))
    row["library_ms"] = None
    # x read and written in bf16, the fp32 tables read once
    row["ops_ms"], row["bytes_ms"] = elem_bound(3 * qd.numel(), 2 * 2 * qd.numel() + 2 * 4 * cos.numel())
    row["bound_ms"], row["bound_by"] = max(row["ops_ms"], row["bytes_ms"]), bound_by(row["ops_ms"], row["bytes_ms"])
    row["roofline_share"] = row["bound_ms"] / row["ms"]
    row["device_roofline_share"] = row["bound_ms"] / row["device_ms"]
    row["max_abs_err"] = max(row["bf16_q_err"], row["bf16_k_err"])
    emit({"phase": "rotary", **row})
    del module
    torch.cuda.empty_cache()
    return launched, row



# Launches per unit of the ACDC and skin paths by the router's rule (a site
# reaches its kernel when B·h·N·M·4 bytes pass 32 MiB): a training step at
# batch 8 routes DSEB1, DSEB2 and dec1 (both presets); an ACDC val chunk of 8
# (one slice, padded) DSEB1, DSEB2 and dec1; an ACDC test chunk of 32 also
# dec2 (DSEB3 only from 55 images); a skin eval batch of 8 DSEB1, DSEB2 and
# dec1, one of at most 6 images (a split's last) DSEB1 and dec1 only.
PRESET_PER_UNIT = {
    "train step": TRAIN_PER_STEP["interleaved"],
    "acdc val chunk": {"diff_attention_interleaved_fwd": 2, "attention_fwd": 1},
    "acdc test chunk": {"diff_attention_interleaved_fwd": 2, "attention_fwd": 2},
    "skin batch of 8": {"diff_attention_interleaved_fwd": 2, "attention_fwd": 1},
    "skin batch of at most 6": {"diff_attention_interleaved_fwd": 1, "attention_fwd": 1},
}


def expected_launches(units, names=()):
    """The launches of ``units`` ({unit name: count}) by ``PRESET_PER_UNIT``,
    with 0 for each of ``names`` that they do not launch."""
    want = dict.fromkeys(names, 0)
    for unit, count in units.items():
        for name, n in PRESET_PER_UNIT[unit].items():
            want[name] = want.get(name, 0) + n * count
    return want


def read_json(path):
    with open(path) as f:
        return json.load(f)


def cascade_fired_on_epoch_0(log) -> bool:
    """The CLI's log lines show epoch 0's test, then a new ``best`` saved."""
    first = next((i for i, line in enumerate(log) if " test dice " in line), None)
    return (first is not None and log[first].startswith("epoch 0 test dice")
            and any(line.startswith("new best test dice") for line in log[first + 1:first + 2]))


def kernels_against_twins(model, x, where):
    """One bf16 eval batch ``x`` through ``model`` with the kernels (the launch
    counts of that forward) and on the card's plain math (``router``'s limit
    raised, as ``twins_on_card`` does), against the same batch in fp32 on the
    plain math: the kernels' distance from fp32, in max abs and in norm, at
    most twice the plain bf16 path's (both round the same activations to bf16
    at other points), and their labels agree with the plain bf16 path's on at
    least 99% of pixels. Returns the readings."""
    K.reset_launches()
    kern = make_predict_fn(model, torch.bfloat16)(x)
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    limit = router._SMALL_LIMIT
    router._SMALL_LIMIT = 1 << 62
    try:
        plain = make_predict_fn(model, torch.bfloat16)(x)
        fp32 = make_predict_fn(model, torch.float32)(x)
    finally:
        router._SMALL_LIMIT = limit
    out = {"launches": launched, "max_abs_vs_plain": amax(kern - plain),
           "max_abs_vs_fp32": amax(kern - fp32), "plain_max_abs_vs_fp32": amax(plain - fp32),
           "norm_vs_fp32": rel_norm(kern, fp32), "plain_norm_vs_fp32": rel_norm(plain, fp32),
           "argmax_agree_vs_plain": float((kern.argmax(1) == plain.argmax(1)).float().mean())}
    check(out["max_abs_vs_fp32"] <= 2 * out["plain_max_abs_vs_fp32"]
          and out["norm_vs_fp32"] <= 2 * out["plain_norm_vs_fp32"] and out["argmax_agree_vs_plain"] >= 0.99,
          f"{where}: the kernels' bf16 batch against the plain math: {out}")
    return out


def drive_cli(argv, calls=()):
    """``cli.main(argv)`` in-process with its stdout caught, the launch counts
    from zero, and ``calls`` ((module, function name) pairs that the CLI looks
    up when it calls them) wrapped to record their seconds: (result, stdout
    lines, launches, the seconds of each call by function name, the wall
    seconds)."""
    import io

    from cenet_tpu_torch.cli import main as cli

    seconds = {name: [] for _, name in calls}
    saved = [(module, name, getattr(module, name)) for module, name in calls]

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            result = fn(*a, **kw)
            seconds[name].append(time.perf_counter() - t0)
            return result

        return call

    out = io.StringIO()
    for module, name, fn in saved:
        setattr(module, name, timed(name, fn))
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    return result, out.getvalue().strip().splitlines(), dict(K.LAUNCHES), seconds, time.perf_counter() - t0


def phase_acdc():
    """6c: the ACDC workload. Seeded ACDC-like files at 256 × 216 (64 train and
    4 valid slices, two 10-slice test volumes, labels 0–3), then ``cli.main(["train",
    "--preset", "acdc", …, "--max_epochs", "2", "--throughput"])`` at the
    preset's full width (CENet-b2, 224², batch 8, bf16) and ``cli.main(["eval",
    "--preset", "acdc", …])`` from its snapshot. Requires: the launches that
    ``PRESET_PER_UNIT`` gives for its 16 steps, 8 val chunks and the test
    chunks of each test the cascade ran; the val → test → ``best`` cascade
    fired on epoch 0 and ``best`` written; tags, step files, curve rows and
    finite losses; the eval JSON equal to ``run_inference`` (full metrics,
    unnormalised) on the ``best`` weights loaded apart, with 2 test chunks'
    launches; one bf16 batch of 8 slices through the kernels held against the
    plain math (``kernels_against_twins``: 2 K1, 1 K2). Reports the phase's
    seconds, ``--throughput`` img/s and the seconds of each val and test.
    Returns the launch counts of the train run."""
    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core.checkpoint import CheckpointManager, load_checkpoint
    from cenet_tpu_torch.data.acdc import ACDCDataset

    cfg = get_preset("acdc")
    t_phase = time.perf_counter()
    losses, train_step = [], Trainer.train_step

    def recording_step(self, images, labels):
        losses.append(train_step(self, images, labels))
        return losses[-1]

    with tempfile.TemporaryDirectory() as root:
        # ACDC's layout at an ACDC-like 256 × 216: 64 train and 4 valid slices, two 10-slice test volumes
        write_acdc(root, seed=31, n_train=64, n_valid=4, n_test=2, depth=10)
        common = ["--preset", "acdc", "--root_path", root, "--list_dir", root, "--output_dir",
                  os.path.join(root, "out"), "--max_epochs", "2"]
        Trainer.train_step = recording_step
        try:
            trainer, lines, launches, seconds, train_s = drive_cli(["train", *common, "--throughput"],
                                                                   ((cli, "_acdc_val"), (cli, "_volume_eval")))
        finally:
            Trainer.train_step = train_step
        steps = trainer.step
        del trainer
        torch.cuda.empty_cache()
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(["train", *common])))
        mgr = CheckpointManager(snap)
        tags, step_files = mgr.available_tags(), mgr.all_steps()
        with open(os.path.join(snap, "result.tsv")) as f:
            rows = [line.split("\t") for line in f.read().splitlines()[1:]]
        best = read_json(os.path.join(snap, "metrics_best.json")) if "best" in tags else None
        throughput = json.loads(lines[-1])
        result, eval_lines, eval_launches, _, eval_s = drive_cli(["eval", *common])
        model = load_checkpoint(build_model(cfg, device=DEV, seed=1), os.path.join(snap, "best.pth"))
        predict = make_predict_fn(model, torch.bfloat16)
        inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=cfg.data.img_size, normalize=False,
                                                              num_classes=cfg.model.num_classes), device=DEV)
        cases = list(ACDCDataset(root, root, "test", cfg.data.img_size, preload=False).volumes())
        dice, hd = run_inference(inf, cases, full_metrics=True)
        ds = ACDCDataset(root, root, "train", cfg.data.img_size)
        x = torch.from_numpy(np.stack([ds.get_train(i, np.random.default_rng(i))["image"] for i in range(TRAIN_B)])
                             .transpose(0, 3, 1, 2).copy()).to(DEV)
        twins = kernels_against_twins(model, x, "acdc eval batch of 8")
        del model
        torch.cuda.empty_cache()
    loss_values = torch.stack(losses).cpu().tolist()
    tests, test_chunks = len(seconds["_volume_eval"]), sum(-(-c["image"].shape[0] // CHUNK) for c in cases)
    val_chunks = 2 * 4  # two epochs of four valid slices, one padded chunk each
    want = expected_launches({"train step": steps, "acdc val chunk": val_chunks,
                              "acdc test chunk": tests * test_chunks}, launches)
    log = [line.split("] ", 1)[-1] for line in lines if " val dice " in line or " test dice " in line]
    emit({"phase": "acdc", "steps": steps, "losses": loss_values, "tags": tags, "step_files": step_files,
          "result_rows": rows, "best": best, "log": log, "throughput": throughput,
          "img_per_s": throughput.get("value"), "train_s": train_s, "val_s": seconds["_acdc_val"],
          "test_s": seconds["_volume_eval"], "launches": launches, "expected_launches": want,
          "cli_eval": {"printed": result, "direct": {"mean_dice": dice, "mean_hd95": hd}, "seconds": eval_s,
                       "launches": eval_launches},
          "kernels_against_twins": twins, "phase_s": time.perf_counter() - t_phase})
    check(steps == 16 and launches == want, f"acdc train: {steps} steps, launches {launches}, expected {want}")
    check(cascade_fired_on_epoch_0(log) and best is not None and "best" in tags,
          f"acdc train: the cascade did not fire on epoch 0: {log}")
    check(tags[:2] == ["best", "final"] and 1 <= len(step_files) <= cfg.train.ckpt_keep and len(rows) == 2,
          f"acdc train: tags {tags}, step files {step_files}, curve rows {rows}")
    check(len(loss_values) == steps and all(np.isfinite(loss_values)), f"acdc train: losses {loss_values}")
    check(throughput.get("metric") == "train_images_per_sec" and throughput.get("value", 0) > 0,
          f"acdc train: the last line is not the --throughput line: {lines[-1]}")
    check(result == {"mean_dice": dice, "mean_hd95": hd} and json.loads(eval_lines[-1]) == result,
          f"acdc eval printed {result}, run_inference on the best weights {(dice, hd)}")
    check_launches(eval_launches, PRESET_PER_UNIT["acdc test chunk"], test_chunks, "acdc eval")
    check_launches(twins["launches"], PRESET_PER_UNIT["acdc val chunk"], 1, "acdc eval batch of 8")
    return launches


def phase_skin(dataset="ph2"):
    """6d: the PH2 workload. A seeded 200-image ``np/`` cache at 224² (PH2's
    80/20/100 split), then ``cli.main(["train", "--preset", "ph2", …,
    "--max_epochs", "1", "--throughput"])`` at the preset's full width
    (CENet-b2, 224², batch 8, bf16) and ``cli.main(["eval", "--preset", "ph2",
    …])`` from its snapshot. Requires: the launches that ``PRESET_PER_UNIT``
    gives for its 10 steps, the val split's batches (8, 8, 4) and, for each test
    the cascade ran, the test split's (12 of 8, one of 4); the cascade fired on
    epoch 0 and ``best`` written; finite losses; the eval JSON ``{"dice", "acc",
    "iou"}`` equal to ``skin_test`` on the ``best`` weights loaded apart, with
    the test split's launches; one bf16 batch of 8 images through the kernels
    held against the plain math (2 K1, 1 K2). Reports the phase's seconds,
    ``--throughput`` img/s and the seconds of each val and test. Returns the
    launch counts of the train run."""
    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core.checkpoint import CheckpointManager, load_checkpoint
    from cenet_tpu_torch.data.skin import SkinDataset
    from cenet_tpu_torch.evaluate import skin as SKIN

    cfg = get_preset(dataset)
    t_phase = time.perf_counter()
    losses, train_step = [], Trainer.train_step

    def recording_step(self, images, labels):
        losses.append(train_step(self, images, labels))
        return losses[-1]

    def batch_units(n):
        full, last = divmod(n, TRAIN_B)
        units = {"skin batch of 8": full}
        if last:
            check(last <= 6, f"{dataset}: a last batch of {last} images routes DSEB2 too")
            units["skin batch of at most 6"] = 1
        return units

    with tempfile.TemporaryDirectory() as root:
        write_skin_cache(root, size=cfg.data.img_size, n=200, seed=41)  # PH2's 80/20/100 split
        common = ["--preset", dataset, "--root_path", root, "--output_dir", os.path.join(root, "out"),
                  "--max_epochs", "1"]
        Trainer.train_step = recording_step
        try:
            trainer, lines, launches, seconds, train_s = drive_cli(["train", *common, "--throughput"],
                                                                   ((cli, "_quick_val"), (SKIN, "skin_test")))
        finally:
            Trainer.train_step = train_step
        steps = trainer.step
        del trainer
        torch.cuda.empty_cache()
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(["train", *common])))
        tags = CheckpointManager(snap).available_tags()
        best = read_json(os.path.join(snap, "metrics_best.json")) if "best" in tags else None
        throughput = json.loads(lines[-1])
        result, eval_lines, eval_launches, _, eval_s = drive_cli(["eval", *common])
        model = load_checkpoint(build_model(cfg, device=DEV, seed=1), os.path.join(snap, "best.pth"))
        test = SkinDataset(dataset, root, "test", cfg.data.img_size)
        n_val, n_test = len(SkinDataset(dataset, root, "val", cfg.data.img_size)), len(test)
        direct = SKIN.skin_test(make_predict_fn(model, torch.bfloat16), cli._skin_batches(test, TRAIN_B, DEV))
        x = next(cli._skin_batches(test, TRAIN_B, DEV))["image"]
        twins = kernels_against_twins(model, x, f"{dataset} eval batch of 8")
        del model
        torch.cuda.empty_cache()
    loss_values = torch.stack(losses).cpu().tolist()
    tests = len(seconds["skin_test"])
    units = collections.Counter({"train step": steps})
    units.update(batch_units(n_val))
    for _ in range(tests):
        units.update(batch_units(n_test))
    want = expected_launches(units, launches)
    log = [line.split("] ", 1)[-1] for line in lines if " val dice " in line or " test dice " in line]
    emit({"phase": dataset, "steps": steps, "losses": loss_values, "tags": tags, "best": best, "log": log,
          "throughput": throughput, "img_per_s": throughput.get("value"), "train_s": train_s,
          "val_s": seconds["_quick_val"], "test_s": seconds["skin_test"], "split": [steps * TRAIN_B, n_val, n_test],
          "launches": launches, "expected_launches": want,
          "cli_eval": {"printed": result, "direct": dict(zip(("dice", "acc", "iou"), direct)), "seconds": eval_s,
                       "launches": eval_launches},
          "kernels_against_twins": twins, "phase_s": time.perf_counter() - t_phase})
    check(steps == 10 and launches == want, f"{dataset} train: {steps} steps, launches {launches}, expected {want}")
    check(cascade_fired_on_epoch_0(log) and best is not None and "best" in tags,
          f"{dataset} train: the cascade did not fire on epoch 0: {log}")
    check(len(loss_values) == steps and all(np.isfinite(loss_values)), f"{dataset} train: losses {loss_values}")
    check(throughput.get("metric") == "train_images_per_sec" and throughput.get("value", 0) > 0,
          f"{dataset} train: the last line is not the --throughput line: {lines[-1]}")
    check(result == dict(zip(("dice", "acc", "iou"), direct)) and json.loads(eval_lines[-1]) == result,
          f"{dataset} eval printed {result}, skin_test on the best weights {direct}")
    check_launches(eval_launches, expected_launches(batch_units(n_test)), 1, f"{dataset} eval")
    check_launches(twins["launches"], PRESET_PER_UNIT["skin batch of 8"], 1, f"{dataset} eval batch of 8")
    return launches


def zoo_per_unit(cfg, batch):
    """The kernel launches of one train step (``batch`` images) and one eval
    chunk of ``batch`` slices of ``cfg``'s model, by the router's rule: a DSEB
    or SkipEnhancer site reaches K1 (and K3 in a step) when its map,
    B·h·N²·4 bytes, passes ``router._SMALL_LIMIT``; a Nonlocal site reaches K2
    (and K4) when B·N²·4 does. The sites: skip enhancers at the encoder's
    strides 16, 8, 4 with heads ``diffatt_num_heads`` in that order; Nonlocal
    at every CFAM, strides 32 to 4. Returns (per step, per chunk)."""
    from cenet_tpu_torch.models.encoder import ENCODER_CHANNELS

    m = cfg.model
    ch = ENCODER_CHANNELS[m.encoder]
    side = [cfg.data.img_size // s for s in (32, 16, 8, 4)]
    n_diff = sum(batch * heads * side[i + 1] ** 4 * 4 > router._SMALL_LIMIT
                 for i, heads in enumerate(m.diffatt_num_heads))
    n_attn = sum(batch * side[i] ** 4 * 4 > router._SMALL_LIMIT for i in range(len(ch)))
    fwd = {"diff_attention_interleaved_fwd": n_diff, "attention_fwd": n_attn}
    step = {**fwd, "diff_attention_interleaved_bwd": n_diff, "attention_bwd": n_attn}
    return ({k: v for k, v in step.items() if v}, {k: v for k, v in fwd.items() if v})


def phase_zoo(version, encoder, tag, n_slices=24):
    """6e/6f: a model of the zoo through the CLI at the Synapse preset's full
    width (224², batch 8, bf16): ``cli.main(["train", "--preset", "synapse",
    "--model_version", version, "--encoder", encoder, …])`` for one epoch over
    ``n_slices`` seeded 512² slices (three steps) with a snapshot eval of one
    seeded 16 × 512² case in memory, then ``cli eval --checkpoint <snapshot>``
    over the same case. Requires: the launches ``zoo_per_unit`` predicts for
    the steps and the eval's chunk (its sum printed beside them); finite
    losses; the ``final`` tag; eval's JSON equal to ``run_inference`` on the
    ``final`` weights loaded apart (the metrics of masks seen before read back,
    ``MetricMemo``) and to the snapshot's row; one bf16 eval batch of 8 through
    the kernels held against the plain math (``kernels_against_twins``).
    Returns the launch counts of the train run."""
    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    memo = MetricMemo()
    losses, train_step = [], Trainer.train_step

    def recording_step(self, images, labels):
        losses.append(train_step(self, images, labels))
        return losses[-1]

    case = synthetic_case(51, d=16)
    test_set = InMemoryVolumes([case])
    with tempfile.TemporaryDirectory() as root:
        full = synthetic_case(52, d=n_slices)
        names = []
        for i, (image, label) in enumerate(zip(full["image"], full["label"])):
            names.append(f"zoo_slice{i:03d}")
            np.savez(os.path.join(root, names[-1] + ".npz"), image=image, label=label)
        with open(os.path.join(root, "train.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        common = ["--preset", "synapse", "--model_version", version, "--encoder", encoder, "--root_path", root,
                  "--list_dir", root, "--output_dir", os.path.join(root, "out"), "--max_epochs", "1",
                  "--eval_interval", "1"]
        argv = ["train", *common]
        cfg = cli.make_config(cli.build_argparser().parse_args(argv))
        Trainer.train_step = recording_step
        K.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()), memo.installed():
                trainer = cli.main(argv, test_set=test_set)
            torch.cuda.synchronize()
        finally:
            Trainer.train_step = train_step
        train_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        steps, model_class = trainer.step, type(trainer.model).__name__
        backbone_class = type(trainer.model.backbone).__name__
        del trainer
        torch.cuda.empty_cache()
        snap = cli.snapshot_path(cfg)
        with open(os.path.join(snap, "result.tsv")) as f:
            rows = [line.split("\t") for line in f.read().splitlines()[1:]]
        out = io.StringIO()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), memo.installed():
            result = cli.main(["eval", *common, "--checkpoint", snap], test_set=test_set)
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t0, dict(K.LAUNCHES)
        final = os.path.join(snap, "final.pth")
        model = load_checkpoint(build_model(cfg, device=DEV, seed=1), final, version)
        inf = VolumeInferencer(make_predict_fn(model, torch.bfloat16),
                               VolumeInferenceConfig(img_size=cfg.data.img_size, num_classes=cfg.model.num_classes),
                               device=DEV)
        with memo.installed():
            dice, hd = run_inference(inf, [case])
        x = torch.from_numpy(np.ascontiguousarray(full["image"][:TRAIN_B, None])).to(DEV)
        x = torch.nn.functional.interpolate(x, size=(cfg.data.img_size,) * 2, mode="bilinear")
        twins = kernels_against_twins(model, x, f"{tag} eval batch of 8")
        del model, inf
        torch.cuda.empty_cache()
    loss_values = torch.stack(losses).cpu().tolist()
    per_step, per_batch8 = zoo_per_unit(cfg, TRAIN_B)
    _, eval_chunk = zoo_per_unit(cfg, CHUNK)
    chunks = -(-case["image"].shape[0] // CHUNK)
    want = {name: per_step.get(name, 0) * steps + eval_chunk.get(name, 0) * chunks for name in launches}
    snapshot = {"mean_dice": float(rows[-1][1]), "mean_hd95": float(rows[-1][2])} if rows else None
    emit({"phase": tag, "model_version": version, "encoder": encoder, "model": model_class,
          "backbone": backbone_class, "steps": steps, "losses": loss_values, "train_s": train_s,
          "launches": launches, "predicted_per_step": per_step, "predicted_per_chunk": eval_chunk,
          "predicted_per_batch_of_8": per_batch8, "expected_launches": want, "snapshot": snapshot,
          "cli_eval": {"printed": result, "direct": {"mean_dice": dice, "mean_hd95": hd}, "seconds": eval_s,
                       "launches": eval_launches},
          "kernels_against_twins": twins, "phase_s": time.perf_counter() - t_phase})
    check(steps == n_slices // TRAIN_B and launches == want,
          f"{tag} train: {steps} steps, launches {launches}, expected {want}")
    check(len(loss_values) == steps and all(np.isfinite(loss_values)), f"{tag} train: losses {loss_values}")
    check(result == {"mean_dice": dice, "mean_hd95": hd} == snapshot,
          f"{tag} eval printed {result}, run_inference on the final weights {(dice, hd)}, snapshot {snapshot}")
    check_launches(eval_launches, eval_chunk, chunks, f"{tag} eval")
    check_launches(twins["launches"], per_batch8, 1, f"{tag} eval batch of 8")
    return launches


# ---------------------------------------------------------------------------
# Phase 6k: K1 and K3 past head dim 128 (csrc/diff_attention_wide.cuh)
# ---------------------------------------------------------------------------

# (site, h, n, d, dv, batch): the diff sites past head dim 128 that the presets'
# paths route at their own batches (tests/test_torch_site_widths.py holds the
# census): the PH2 preset on a ResNet-50 (DSEB1 routed from 1 image, DSEB2 from
# 7: both at its batch of 8), ACDC's on a ResNet-50 (DSEB2 from 4), and ACDC's
# PVT-b2 at a batch of 64 (DSEB3 from 55)
WIDE_SITES = [("ph2-resnet50 DSEB1", 2, 3136, 128, 256, 8), ("ph2-resnet50 DSEB2", 2, 784, 256, 512, 8),
              ("acdc-resnet50 DSEB2", 4, 784, 128, 256, 8), ("acdc-b2 DSEB3", 4, 196, 80, 160, 64)]
WIDE_B = 64  # phase 6k (c): the ACDC-b2 step's batch
# pvt_v2_b2's attention blocks at 224², (blocks, heads, tokens, reduced keys) per
# stage: at a batch of 64 the router also sends stage 1's (from 55 images) to K2
# and K4, which ``zoo_per_unit`` (the decoder's sites) leaves out
PVT_B2_ATTENTION = [(3, 1, 3136, 49), (4, 2, 784, 49), (6, 5, 196, 49), (3, 8, 49, 49)]


def wide_design_factor(kernel, d, dv):
    """FLOPs of the wide designs over the least (``bound``, ``bwd_bound``): the
    logits are formed again for each 128-column slice of an output (s_d slices
    of d, s_v of dv); csrc/diff_attention_wide.cuh."""
    sd, sv = -(-d // 128), -(-dv // 128)
    if kernel == "diff_attention_interleaved_fwd":
        return (4 * sv * d + dv) / (2 * d + dv)
    return (6 * d + 2 * dv + 4 * sd * (d + dv) + 2 * sv * d) / (6 * d + 2 * dv)


def wide_times(row, kernel, fn, plain, lib, args, batch, h, n, d, dv, exp_rate, bound_fn):
    """The timing columns of a phase 6k row on the bf16 inputs at the site's batch."""
    row["ms"] = time_ms(lambda: fn(*args))
    row["device_ms"] = graph_ms(fn, rotated(args))
    # the twin's maps at the site's batch are large: time it over the same inputs in slices of 2
    row["plain_ms"] = time_ms(lambda: [plain(*piece(args, i)) for i in range(0, batch, 2)], reps=1)
    row["library_ms"] = time_ms(lib)
    row["library_backend"] = sdpa_backend(lib)
    row["ops_ms"], row["bytes_ms"] = bound_fn(kernel, batch, h, n, d, dv, 2)
    row["bound_ms"], row["bound_by"] = max(row["ops_ms"], row["bytes_ms"]), bound_by(row["ops_ms"], row["bytes_ms"])
    row["roofline_share"] = row["bound_ms"] / row["ms"]
    row["device_roofline_share"] = row["bound_ms"] / row["device_ms"]
    row["design_flops_factor"] = wide_design_factor(kernel, d, dv)
    row["exp_ms"] = exp_count(kernel, batch, h, n) / exp_rate * 1e3


def phase_wide_sites(exp_rate):
    """6k (a): K1 and K3 at each of ``WIDE_SITES``: against their twins at batch
    2 in fp32 and bf16 and at the site's batch in bf16 (in slices of 2), two
    runs there equal to the bit, and their times there (events, device time)
    beside the twin's, two SDPA calls' (and the backend SDPA took), the bound
    and the design's FLOPs over the bound. Returns the forward and backward rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(6)
    fwd, bwd = "diff_attention_interleaved_fwd", "diff_attention_interleaved_bwd"
    fwd_rows, bwd_rows = [], []
    for site, h, n, d, dv, batch in WIDE_SITES:
        row = {"site": site, "kernel": fwd, "batch": batch, "h": h, "n": n, "d": d, "dv": dv}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = site_inputs(fwd, 2, h, n, d, dv, dtype, gen)
            row.update({f"{label}_{k}": v for k, v in fwd_check(fwd, args, K.diff_attention_interleaved_fwd(*args),
                                                                  f"{site} {label}").items()})
        args = site_inputs(fwd, batch, h, n, d, dv, torch.bfloat16, gen)
        got = K.diff_attention_interleaved_fwd(*args)
        row.update({f"main_{k}": v for k, v in
                    in_slices(fwd_check, fwd, args, got, f"{site} bf16 batch {batch}").items()})
        again = K.diff_attention_interleaved_fwd(*args)
        row["repeat_bit_identical"] = all(torch.equal(a, b) for a, b in zip(got, again))
        check(row["repeat_bit_identical"], f"{fwd} at {site}: two runs on the same inputs differ")
        del got, again
        wide_times(row, fwd, K.diff_attention_interleaved_fwd, plain_fn(fwd), library_fn(fwd, args), args, batch, h,
                   n, d, dv, exp_rate, bound)
        del args
        torch.cuda.empty_cache()
        emit({"phase": "wide_kernels", **row})
        fwd_rows.append(row)

        row = {"site": site, "kernel": bwd, "batch": batch, "h": h, "n": n, "d": d, "dv": dv}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            _, call = bwd_call_args(bwd, 2, h, n, d, dv, dtype, gen)
            row.update({f"{label}_{k}": v for k, v in bwd_site_check(bwd, call, f"{site} {label}").items()})
        _, call = bwd_call_args(bwd, batch, h, n, d, dv, torch.bfloat16, gen)
        row.update({f"main_{k}": v for k, v in bwd_site_check(bwd, call, f"{site} bf16 batch {batch}").items()})
        first, again = K.diff_attention_interleaved_bwd(*call), K.diff_attention_interleaved_bwd(*call)
        row["repeat_bit_identical"] = {g: bool(torch.equal(a, b)) for g, a, b in zip(("dq", "dk", "dv", "dlam"),
                                                                                    first, again)}
        check(all(row["repeat_bit_identical"].values()),
              f"{bwd} at {site}: two runs on the same inputs differ: {row['repeat_bit_identical']}")
        del first, again
        wide_times(row, bwd, K.diff_attention_interleaved_bwd, K.diff_attention_interleaved_bwd_plain,
                   bwd_library_fn(bwd, call), call, batch, h, n, d, dv, exp_rate, bwd_bound)
        del call
        torch.cuda.empty_cache()
        emit({"phase": "wide_bwd_kernels", **row})
        bwd_rows.append(row)
    K.reset_launches()
    return fwd_rows, bwd_rows


@contextlib.contextmanager
def diff_widths():
    """While open, every call of K1's and K3's wrappers is counted by its head
    dims in the Counter yielded ("fwd 128x256", "bwd 256x512"); the wrappers
    count their launches as always."""
    counts = collections.Counter()
    fwd, bwd = K.diff_attention_interleaved_fwd, K.diff_attention_interleaved_bwd

    def counted_fwd(q, k, v, lam):
        counts[f"fwd {q.shape[-1]}x{v.shape[-1]}"] += 1
        return fwd(q, k, v, lam)

    def counted_bwd(q, k, v, lam, lse1, lse2, do):
        counts[f"bwd {q.shape[-1]}x{v.shape[-1]}"] += 1
        return bwd(q, k, v, lam, lse1, lse2, do)

    K.diff_attention_interleaved_fwd, K.diff_attention_interleaved_bwd = counted_fwd, counted_bwd
    try:
        yield counts
    finally:
        K.diff_attention_interleaved_fwd, K.diff_attention_interleaved_bwd = fwd, bwd


def batches_launches(cfg, n, units=None):
    """The forward launches of ``n`` images in batches of ``TRAIN_B`` (the last
    one shorter), by ``zoo_per_unit``, added to ``units``."""
    units = collections.Counter() if units is None else units
    full, last = divmod(n, TRAIN_B)
    for size, count in ((TRAIN_B, full), (last, 1 if last else 0)):
        for name, k in zoo_per_unit(cfg, size)[1].items():
            units[name] += k * count
    return units


def phase_wide_cli():
    """6k (b): ``cli.main(["train", "--preset", "ph2", "--encoder", "resnet50",
    …, "--max_epochs", "1"])`` at full width (CENet-resnet50, 224², batch 8,
    bf16) on phase 6d's seeded 200-image cache, then ``cli.main(["eval", …,
    "--checkpoint", "<snapshot>/final.pth"])``. Requires: launches as
    ``zoo_per_unit`` predicts them for the 10 steps and every eval batch (the
    cascade's val and test, the eval's test split); K1 and K3 at DSEB1's
    (128, 256) and DSEB2's (256, 512) in every step; finite losses; eval's JSON
    finite. Returns the train run's launches and the widths counted."""
    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.data.skin import SkinDataset
    from cenet_tpu_torch.evaluate import skin as SKIN

    t_phase = time.perf_counter()
    losses, train_step = [], Trainer.train_step

    def recording_step(self, images, labels):
        losses.append(train_step(self, images, labels))
        return losses[-1]

    with tempfile.TemporaryDirectory() as root:
        write_skin_cache(root, size=224, n=200, seed=41)  # phase 6d's cache: PH2's 80/20/100 split
        common = ["--preset", "ph2", "--encoder", "resnet50", "--root_path", root, "--output_dir",
                  os.path.join(root, "out"), "--max_epochs", "1"]
        cfg = cli.make_config(cli.build_argparser().parse_args(["train", *common]))
        Trainer.train_step = recording_step
        try:
            with diff_widths() as widths:
                trainer, _, launches, seconds, train_s = drive_cli(["train", *common],
                                                                   ((cli, "_quick_val"), (SKIN, "skin_test")))
        finally:
            Trainer.train_step = train_step
        steps = trainer.step
        del trainer
        torch.cuda.empty_cache()
        final = os.path.join(cli.snapshot_path(cfg), "final.pth")
        with diff_widths() as eval_widths:
            result, _, eval_launches, _, eval_s = drive_cli(["eval", *common, "--checkpoint", final])
        n_val, n_test = (len(SkinDataset("ph2", root, split, cfg.data.img_size)) for split in ("val", "test"))
    loss_values = torch.stack(losses).cpu().tolist()
    per_step, _ = zoo_per_unit(cfg, TRAIN_B)
    want = collections.Counter({name: k * steps for name, k in per_step.items()})
    for _ in seconds["_quick_val"]:
        batches_launches(cfg, n_val, want)
    for _ in seconds["skin_test"]:
        batches_launches(cfg, n_test, want)
    want = {name: want.get(name, 0) for name in launches}
    eval_want = {name: batches_launches(cfg, n_test).get(name, 0) for name in eval_launches}
    emit({"phase": "wide_cli", "steps": steps, "losses": loss_values, "train_s": train_s,
          "val_s": seconds["_quick_val"], "test_s": seconds["skin_test"], "launches": launches,
          "expected_launches": want, "widths": dict(widths), "predicted_per_step": per_step,
          "cli_eval": {"printed": result, "seconds": eval_s, "launches": eval_launches, "widths": dict(eval_widths)},
          "phase_s": time.perf_counter() - t_phase})
    check(steps == 10 and launches == want, f"6k cli train: {steps} steps, launches {launches}, expected {want}")
    check(widths["bwd 128x256"] == steps and widths["bwd 256x512"] == steps
          and widths["fwd 128x256"] >= steps and widths["fwd 256x512"] >= steps,
          f"6k cli train: K1/K3 widths {dict(widths)} over {steps} steps")
    check(len(loss_values) == steps and all(np.isfinite(loss_values)), f"6k cli train: losses {loss_values}")
    check(eval_launches == eval_want and eval_widths["fwd 128x256"] > 0 and eval_widths["fwd 256x512"] > 0,
          f"6k cli eval: launches {eval_launches} (expected {eval_want}), widths {dict(eval_widths)}")
    check(set(result) == {"dice", "acc", "iou"} and all(np.isfinite(list(result.values()))),
          f"6k cli eval printed {result}")
    return launches, widths, eval_launches


def phase_wide_acdc_step():
    """6k (c): one bf16 ``Trainer`` step of the ACDC preset (CENet-b2, 224²) at
    a batch of ``WIDE_B``, where DSEB3 (d 80, dv 160) is routed beside DSEB1,
    DSEB2, dec1, dec2 and the PVT's three stage-1 blocks: launches as
    ``zoo_per_unit`` and ``PVT_B2_ATTENTION`` predict, K1 and K3 once each at
    DSEB3's widths, a finite loss; the step's ms (a second step, CUDA
    events) and peak memory. Returns the first step's launches."""
    base = get_preset("acdc")
    cfg = base.replace(train=dataclasses.replace(base.train, batch_size=WIDE_B))
    trainer = Trainer(cfg, 10, device=DEV, model_seed=3)
    gen = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn(WIDE_B, 1, 224, 224, generator=gen, device=DEV)
    y = torch.randint(0, cfg.model.num_classes, (WIDE_B, 224, 224), generator=gen, device=DEV, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with diff_widths() as widths:
        loss = float(trainer.train_step(x, y))
    launched = dict(K.LAUNCHES)
    step_ms = time_ms(lambda: trainer.train_step(x, y), reps=1)
    per_step = collections.Counter(zoo_per_unit(cfg, WIDE_B)[0])
    encoder = sum(blocks for blocks, h, n, m in PVT_B2_ATTENTION if WIDE_B * h * n * m * 4 > router._SMALL_LIMIT)
    per_step.update({"attention_fwd": encoder, "attention_bwd": encoder})
    want = {name: per_step.get(name, 0) for name in launched}
    row = {"phase": "wide_acdc_step", "batch": WIDE_B, "loss": loss, "launches": launched,
           "expected_launches": want, "widths": dict(widths), "step_ms": step_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    del trainer, x, y
    torch.cuda.empty_cache()
    check(launched == want, f"6k acdc-b2 step at batch {WIDE_B}: launches {launched}, expected {want}")
    check(widths["fwd 80x160"] == 1 and widths["bwd 80x160"] == 1, f"6k acdc-b2 step: widths {dict(widths)}")
    check(np.isfinite(loss), f"6k acdc-b2 step: loss {loss}")
    return launched, widths


# Phase 6k (d): the fp32 step of a random CENet-resnet50 at batch 2 is far
# worse conditioned than phase 3b's CENet-b2: another convolution algorithm
# (cuDNN off) moves its gradients by a median of about 1.7e-2 of their max, and
# fp32 itself departs from float64 by about 2.3e-2 (the phase reports both;
# PERF.md, PR 20). So the kernels are held to the float64 witness beside the
# twins, as phase 3b reports both: no farther from it than the twins in median
# (within WIDE_MEDIAN_RATIO) and in each picked gradient (within
# WIDE_PICKED_RATIO; an H100 read 1.003 and 1.11–1.77).
WIDE_MEDIAN_RATIO = 1.25
WIDE_PICKED_RATIO = 2.0


def phase_wide_parity():
    """6k (d): one fp32 forward/backward of the PH2 preset's CENet-resnet50
    (drop-path off) in train mode at batch 2 on seeded images, TF32 off: the
    card with the kernels (DSEB1 on the wide K1/K3 in fp32, dec1 on the wide
    K2/K4), the card with the twins (``twins_on_card``), the twins with cuDNN
    off (what another convolution algorithm alone moves) and, as the witness
    of all, the twins in float64 on the card. Reports the kernels and the
    native convolutions against the twins and the kernels and the twins
    against the witness; requires the kernels no farther from
    the witness than the twins (``WIDE_MEDIAN_RATIO``, ``WIDE_PICKED_RATIO``)
    and the loss within ``TOL_LOSS`` of the witness's. Returns the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_preset("ph2")
    cfg = base.replace(model=dataclasses.replace(base.model, encoder="resnet50", drop_path_rate=0.0),
                       train=dataclasses.replace(base.train, amp=False))
    card = Trainer(cfg, 1, device=DEV, model_seed=0)
    card.model.train()
    witness = Trainer(cfg, 1, device=DEV, model_seed=0)
    witness.model.double().train()
    witness.compute_dtype = torch.float64
    gen = torch.Generator(device=DEV).manual_seed(8)
    x = torch.rand(2, 3, 224, 224, generator=gen, device=DEV)
    y = torch.randint(0, 2, (2, 224, 224), generator=gen, device=DEV, dtype=torch.int32)
    K.reset_launches()
    with diff_widths() as widths:
        loss, grads = card.loss_and_grads(x, y)
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    plain_loss, plain_grads = twins_on_card(card, x, y)
    torch.backends.cudnn.enabled = False
    try:  # how far another convolution algorithm alone moves the same step
        _, native_grads = twins_on_card(card, x, y)
    finally:
        torch.backends.cudnn.enabled = True
    with float64_stays():
        w_loss, w_grads = twins_on_card(witness, x.double(), y)
    names = [n for n, _ in card.model.named_parameters()]
    scale = {n: amax(w) for n, w in zip(names, w_grads) if w is not None}
    live = {n for n, s in scale.items() if s > 1e-10 * max(scale.values())}

    def rel_errs(gs, ws):
        return {n: rel_max(g, w) for n, g, w in zip(names, gs, ws) if n in live}

    own, k64, t64 = rel_errs(grads, plain_grads), rel_errs(grads, w_grads), rel_errs(plain_grads, w_grads)
    k_med, t_med = float(np.median(list(k64.values()))), float(np.median(list(t64.values())))
    emit({"phase": "wide_parity", "batch": 2, "loss": float(loss), "loss_twins": float(plain_loss),
          "loss_float64": float(w_loss), "grad_rel_err_kernels_vs_twins": summary(own),
          "grad_rel_err_twins_native_conv_vs_twins": summary(rel_errs(native_grads, plain_grads)),
          "grad_rel_err_vs_float64": {"card_kernels": summary(k64), "card_twins": summary(t64)},
          "median_ratio": k_med / t_med, "launches": launched, "widths": dict(widths)})
    del card, witness, grads, plain_grads, native_grads, w_grads
    torch.cuda.empty_cache()
    want = {"diff_attention_interleaved_fwd": 1, "diff_attention_interleaved_bwd": 1, "attention_fwd": 1,
            "attention_bwd": 1}
    check({k: v for k, v in launched.items() if v} == want, f"6k fp32 step: launches {launched}, expected {want}")
    check(widths["fwd 128x256"] == 1 and widths["bwd 128x256"] == 1, f"6k fp32 step: widths {dict(widths)}")
    for run, value in (("kernels", loss), ("twins", plain_loss)):
        check(abs(float(value) - float(w_loss)) <= TOL_LOSS, f"6k fp32 step: {run} loss {float(value)} vs float64 "
              f"{float(w_loss)}")
    check(k_med <= WIDE_MEDIAN_RATIO * t_med, f"6k fp32 step: kernels off float64 by a median {k_med}, twins {t_med}")
    for n in PARITY_GRADS:
        check(k64[n] <= WIDE_PICKED_RATIO * t64[n],
              f"6k fp32 step: the kernels' gradient of {n} off float64 by {k64[n]}, the twins' by {t64[n]}")
    return launched


def phase_wide(exp_rate):
    """Phase 6k: K1 and K3 past head dim 128, (a)–(d). Returns the kernel rows
    and the launches and widths of (b)–(d) by run."""
    t0 = time.perf_counter()
    fwd_rows, bwd_rows = phase_wide_sites(exp_rate)
    t1 = time.perf_counter()
    cli_launches, cli_widths, eval_launches = phase_wide_cli()
    t2 = time.perf_counter()
    step_launches, step_widths = phase_wide_acdc_step()
    t3 = time.perf_counter()
    parity_launches = phase_wide_parity()
    emit({"phase": "wide", "sites_s": t1 - t0, "cli_s": t2 - t1, "acdc_step_s": t3 - t2,
          "parity_s": time.perf_counter() - t3, "phase_s": time.perf_counter() - t0})
    launches = {"cli-train": cli_launches, "cli-eval": eval_launches, "acdc-b2-step": step_launches,
                "fp32-step": parity_launches}
    return fwd_rows, bwd_rows, launches, {"cli-train": dict(cli_widths), "acdc-b2-step": dict(step_widths)}


# ---------------------------------------------------------------------------
# Phase 6j: the Orbax bridge (the JAX package's TrainState read without JAX)
# ---------------------------------------------------------------------------

ORBAX_FIXTURE = os.path.join("tests", "torch_orbax_data")
ORBAX_RESUME_SLICES = 16  # two iterations an epoch at batch 8: the resumed epoch is two steps


def phase_orbax(volume, root):
    """6j: the Orbax bridge on the committed fixture ``tests/torch_orbax_data``
    (``tests/torch_orbax_fixture.py``: the Synapse CENet-b2 TrainState at full
    width, step 37, written by the JAX package's ``CheckpointManager``), with
    no JAX here. (a) The zstd decoder built from its source, then the step read
    by ``core/orbax.py::read_checkpoint``: every leaf's sha256 equal to the
    manifest's (the arrays before conversion), then ``train_state_from_jax``
    into a CENet-b2 ``Trainer`` on the card, every weight, statistic and SGD
    slot equal to the bit to its leaf in the port's layout, count 37; the read
    seconds and decoded MB/s on the card machine's host. (b) ``cli eval --checkpoint
    <fixture>/steps/37`` on phase 4's two cases cut to their first 32 slices
    (one chunk each): K1 and K2 launched as ``VOLUME_PER_CHUNK`` counts, its
    JSON finite. (c) ``cli train --resume`` on a copy of the fixture in the
    snapshot it names, over 16 of phase 6's slices (2 iterations an epoch, so
    step 37 resumes in epoch 18 of 19): resumed at iter 37, two steps with
    K1–K4 launched as ``TRAIN_PER_STEP`` counts, finite losses, step 39, the
    port's ``.pth`` files beside the JAX package's. Returns the launch counts
    of (b) and (c)."""
    import io
    import shutil

    from cenet_tpu_torch import native
    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.convert.jax2torch import _to_torch_layout, torch_names, train_state_from_jax
    from cenet_tpu_torch.core.checkpoint import CheckpointManager
    from cenet_tpu_torch.core.orbax import read_checkpoint

    t_phase = time.perf_counter()
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE)
    with open(os.path.join(fixture, "manifest.json")) as f:
        manifest = json.load(f)
    step_dir = os.path.join(fixture, "steps", str(manifest["step"]))
    t0 = time.perf_counter()
    native.load("zstd")
    build_s = time.perf_counter() - t0
    # (a) read, hash, bridge, load
    t0 = time.perf_counter()
    tree = read_checkpoint(step_dir)
    read_s = time.perf_counter() - t0

    def leaf(path):
        node = tree
        for p in path.split("/"):
            node = node[int(p)] if isinstance(node, list) else node[p]
        return node

    decoded = sum(leaf(r["path"]).nbytes for r in manifest["leaves"])
    bad_hashes = [r["path"] for r in manifest["leaves"]
                  if hashlib.sha256(np.ascontiguousarray(leaf(r["path"])).tobytes()).hexdigest() != r["sha256"]
                  or list(leaf(r["path"]).shape) != r["shape"]]
    cfg = get_preset("synapse")
    t0 = time.perf_counter()
    state = train_state_from_jax(tree, cfg.model.model_version, cfg.train.optimizer)
    convert_s = time.perf_counter() - t0
    trainer = Trainer(cfg, 1, device=DEV)
    t0 = time.perf_counter()
    trainer.load_state_dict(state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live = trainer.model.state_dict()
    names = torch_names({"params": tree["params"], "batch_stats": tree["batch_stats"]}, cfg.model.model_version)
    uncovered = sorted(set(live) - set(names.values()) - {k for k in live if k.endswith("num_batches_tracked")})
    trace = tree["opt_state"][1]["trace"]  # chain(add_decayed_weights, trace, scale_by_learning_rate)
    unequal, slots = [], 0
    for (collection, path), key in names.items():
        node = tree[collection]
        for p in path:
            node = node[p]
        want = torch.from_numpy(np.array(_to_torch_layout(np.asarray(node), path), order="C"))
        if not torch.equal(live[key].cpu(), want):
            unequal.append(key)
        if collection == "params":
            node = trace
            for p in path:
                node = node[p]
            slots += 1
            want = torch.from_numpy(np.array(_to_torch_layout(np.asarray(node), path), order="C"))
            if not torch.equal(trainer.optimizer.state[key]["trace"].cpu(), want):
                unequal.append(f"{key} trace")
    count, live_keys = trainer.step, list(live)
    del trainer, live, state
    torch.cuda.empty_cache()
    check(not bad_hashes, f"orbax: {len(bad_hashes)} leaves differ from the manifest: {bad_hashes[:5]}")
    check(len(manifest["leaves"]) == 1376 and decoded > 260e6, f"orbax: {len(manifest['leaves'])} leaves, {decoded} B")
    check(not unequal and not uncovered and len(live_keys) == 801 and slots == 630 and count == manifest["step"],
          f"orbax: after the load {len(unequal)} tensors differ ({unequal[:5]}), {uncovered[:5]} not checked, "
          f"{slots} slots, count {count}")
    # (b) cli eval of the tag
    cases = [dict(c, image=c["image"][:CHUNK], label=c["label"][:CHUNK]) for c in volume["cases"]]
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli.main(["eval", "--preset", "synapse", "--checkpoint", step_dir, "--output_dir", tmp],
                              test_set=InMemoryVolumes(cases))
        eval_s = time.perf_counter() - t0
        eval_launches = dict(K.LAUNCHES)
        printed = json.loads(out.getvalue().strip().splitlines()[-1])
    # (c) cli train --resume from a copy of the fixture
    losses, train_step = [], Trainer.train_step

    def recording_step(self, images, labels):
        losses.append(train_step(self, images, labels))
        return losses[-1]

    with tempfile.TemporaryDirectory() as tmp:
        lists = os.path.join(tmp, "lists")
        os.makedirs(lists)
        with open(os.path.join(root, "train.txt")) as f:
            slices = f.read().split()[:ORBAX_RESUME_SLICES]
        with open(os.path.join(lists, "train.txt"), "w") as f:
            f.write("\n".join(slices) + "\n")
        epochs = manifest["step"] // (ORBAX_RESUME_SLICES // TRAIN_B) + 1
        argv = ["train", "--preset", "synapse", "--root_path", root, "--list_dir", lists, "--output_dir",
                os.path.join(tmp, "out"), "--max_epochs", str(epochs), "--eval_interval", str(epochs + 1), "--resume"]
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
        shutil.copytree(fixture, snap)
        out = io.StringIO()
        K.reset_launches()
        Trainer.train_step = recording_step
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                trainer = cli.main(argv, test_set=InMemoryVolumes([]))
        finally:
            Trainer.train_step = train_step
        train_s = time.perf_counter() - t0
        train_launches = dict(K.LAUNCHES)
        resumed_step = trainer.step
        del trainer
        torch.cuda.empty_cache()
        mgr = CheckpointManager(snap)
        latest, tags = mgr.latest_step(), mgr.available_tags()
        jax_step_kept = os.path.isdir(os.path.join(snap, "steps", str(manifest["step"]), "default"))
        log = [line.split("] ", 1)[-1] for line in out.getvalue().splitlines() if "resumed from" in line]
    loss_values = torch.stack(losses).float().cpu().tolist() if losses else []
    chunks = len(cases)
    emit({"phase": "orbax", "fixture": ORBAX_FIXTURE, "leaves": len(manifest["leaves"]),
          "decoded_mb": decoded / 1e6, "zstd_build_s": build_s, "read_s": read_s,
          "decoded_mb_per_s": decoded / 1e6 / read_s, "convert_s": convert_s, "load_to_card_s": load_s,
          "hash_mismatches": bad_hashes[:5], "tensors_checked": len(names), "tensors_of_the_model": len(live_keys),
          "uncovered": uncovered[:5], "slots_checked": slots,
          "unequal_after_load": unequal[:5], "count": count,
          "cli_eval": {"printed": printed, "result": result, "chunks": chunks, "seconds": eval_s,
                       "launches": eval_launches},
          "cli_train_resume": {"log": log, "step": resumed_step, "losses": loss_values, "seconds": train_s,
                               "launches": train_launches, "latest_step": latest, "tags": tags,
                               "jax_step_kept": jax_step_kept},
          "phase_s": time.perf_counter() - t_phase})
    check(printed == result and all(np.isfinite(list(result.values()))) and 0.0 <= result["mean_dice"] <= 1.0,
          f"orbax: cli eval printed {printed}, returned {result}")
    check_launches(eval_launches, VOLUME_PER_CHUNK["interleaved"], chunks, "orbax: cli eval of the step")
    resumed = f"resumed from step {manifest['step']} at iter {manifest['step']} (epoch {epochs - 1}, momentum restored)"
    check(log == [resumed] and resumed_step == manifest["step"] + 2, f"orbax: resume log {log}, step {resumed_step}")
    check(len(loss_values) == 2 and all(np.isfinite(loss_values)), f"orbax: resumed losses {loss_values}")
    check_launches(train_launches, TRAIN_PER_STEP["interleaved"], 2, "orbax: cli train --resume")
    check(latest == manifest["step"] + 2 and jax_step_kept and tags[0] == "final",
          f"orbax: after the resume the latest step is {latest}, tags {tags}, the JAX step kept: {jax_step_kept}")
    return {"orbax-eval": eval_launches, "orbax-train": train_launches}


def wide_diff_ptxas():
    """``ptxas``'s registers a thread and spills (bytes) of the wide K1/K3's
    kernels (csrc/diff_attention_wide.cuh), by kernel."""
    out = {}
    for source in ("diff_attention_fwd", "diff_attention_bwd"):
        for name, usage in build.ptxas_usage(source, "dwide").items():
            out[re.search(r"dwide\d+(\w+?_kernel)", name).group(1)] = usage
    return out


def wide_ptxas():
    """``ptxas``'s registers a thread and spills (bytes) of each instance of the
    wide K2/K4's wgmma kernels, by kernel and output columns a warpgroup: the
    split design's fwd, dq and dkv roles and the row-owning forward (whose
    consumers take 240 registers by setmaxnreg beyond the launch's 168)."""
    roles = ("fwd", "dq", "dkv")
    out = {}
    for source in ("attention_fwd", "attention_bwd"):
        for name, usage in build.ptxas_usage(source, "attention_").items():
            m = re.search(r"attention_wide_wgmma_kernelILNS0_4WideE(\d)ELi(\d+)E", name)
            r = re.search(r"attention_fwd_rows_kernelILi(\d+)E", name)
            if m:
                out[f"{roles[int(m.group(1))]} H={m.group(2)}"] = usage
            elif r:
                out[f"fwd rows NV={r.group(1)}"] = usage
    check(len(out) == 13, f"wide wgmma kernels: expected ptxas reports of 4 + 4 fwd, 4 dq and 1 dkv instances: {out}")
    return out


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    exp_rate, sms, mhz = sfu_rate()
    t0 = time.perf_counter()
    specs = (*KERNELS.values(), *BWD_KERNELS.values(), *SWAP_KERNELS.values())
    sources = sorted({os.path.splitext(os.path.basename(spec["source"]))[0] for spec in specs})
    build.build(sources)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sources, "dir": str(build._build_dir()),
          "sm_count": sms, "max_sm_clock_mhz": mhz, "ex2_per_s": exp_rate})
    emit({"phase": "ptxas", "wide_wgmma": wide_ptxas(), "wide_diff": wide_diff_ptxas()})

    launches = {}
    sites, errs = phase_kernels(exp_rate)
    phase_small_limit()
    bwd_sites, bwd_errs, train_fwd_errs = phase_bwd_kernels(exp_rate)
    errs = {k: max(e, train_fwd_errs[k]) for k, e in errs.items()}
    swap_rows, swap_errs, dw_layouts = phase_swap_kernels()
    phase_slice_parity()
    live, _ = phase_train_parity()
    phase_split_train_parity(live)
    launches["volume"], volume = phase_volume()
    launches.update({"volume-split": phase_split_volume(), "volume-swapped": phase_swapped_volume(),
                     "cli-eval": phase_cli_eval(volume)})
    phase_profile()
    with tempfile.TemporaryDirectory() as train_root:
        launches["train"], trainer, images, labels, train_img_per_s, train_wait_ms = phase_train(train_root)
        phase_train_profile(trainer, images, labels)
        launches["train-split"] = phase_split_train(trainer, images, labels)
        launches["train-swapped"] = phase_swapped_train(trainer, images, labels, dw_layouts)
        launches["train-split, K7 and K8"] = phase_split_train(trainer, images, labels, swap_backwards=True)
        del trainer, images, labels
        torch.cuda.empty_cache()
        launches["rotary"], rotary_row = phase_rotary()
        launches["cli-train"] = phase_cli_train(train_root, train_img_per_s)
        launches["remat"] = phase_remat(train_root, train_wait_ms)
        mesh_launches = phase_mesh(train_root)
        launches.update(phase_orbax(volume, train_root))
    ring_launches = phase_ring(volume)
    del volume
    launches["acdc"] = phase_acdc()
    launches["ph2"] = phase_skin("ph2")
    launches["cenet_org"] = phase_zoo("cenet_org", "pvt_v2_b2", "cenet_org")
    launches["resnet50"] = phase_zoo("cenet", "resnet50", "resnet50")
    wide_fwd, wide_bwd, wide_launches, wide_widths = phase_wide(exp_rate)
    errs["diff_attention_interleaved_fwd"] = max(errs["diff_attention_interleaved_fwd"],
                                                 *(r[k] for r in wide_fwd for k in ("bf16_err_o", "main_err_o")))
    bwd_errs["diff_attention_interleaved_bwd"] = max(
        bwd_errs["diff_attention_interleaved_bwd"],
        *(r[f"{p}_{g}_err"] for r in wide_bwd for p in ("bf16", "main") for g in ("dq", "dk", "dv")))
    emit({"phase": "done", "seconds": time.perf_counter() - t0})

    def record(name, spec, rows, err, weight=lambda r: 1):
        def total(key):
            return sum(r[key] * weight(r) for r in rows)

        return {
            "name": name, "k": spec["k"], "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "path": spec["path"], "launches": launches[spec["path"]][name],
            "cli_train_launches": launches["cli-train"].get(name, 0),
            "remat_launches": launches["remat"].get(name, 0),
            "acdc_launches": launches["acdc"].get(name, 0), "ph2_launches": launches["ph2"].get(name, 0),
            "cenet_org_launches": launches["cenet_org"].get(name, 0),
            "resnet50_launches": launches["resnet50"].get(name, 0),
            "mesh_launches": {mesh: mesh_launches.get(name, {}).get(mesh, [0, 0]) for mesh in MESH_CASES},
            "ring_launches": {tag: ring_launches.get(name, {}).get(tag, [0, 0]) for tag in ("step", "eval")},
            "orbax_launches": {tag: launches[f"orbax-{tag}"].get(name, 0) for tag in ("eval", "train")},
            "wide_launches": {run: wide_launches[run].get(name, 0) for run in wide_launches},
            "max_abs_err": err,
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": bound_by(total("ops_ms"), total("bytes_ms")),
            "library_ms": None if any(r["library_ms"] is None for r in rows) else total("library_ms"),
        }

    # forward kernels: launches of their volume path, times for one 32-slice
    # chunk (the sum over their sites); backward kernels: launches of their
    # training path, times for one training step at B=8 (the sum over the sites
    # it routes); K9, K11, K12: each site's time times its calls per forward;
    # K10: the rotary path's forward (q and k) at batch 8
    # (Synapse's sites; K1 and K3 also carry each site of the other presets apart)
    def synapse(r):
        return preset_of(r["site"]) == "synapse"

    def preset_sites(rows):
        keys = ("site", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "library_backend",
                "bound_ms", "bound_by", "roofline_share", "device_roofline_share", "device_loss_factor",
                "repeat_bit_identical")
        return [{k: r[k] for k in keys if k in r} for r in rows if not synapse(r)]

    records = [record(name, spec, [r for r in sites if r["kernel"] == name and synapse(r)], errs[name])
               for name, spec in KERNELS.items()]
    records += [record(name, spec, [r for r in bwd_sites if r["kernel"] == name and "ms" in r and synapse(r)],
                       bwd_errs[name]) for name, spec in BWD_KERNELS.items()]
    for r in records:
        if r["name"] in ("diff_attention_interleaved_fwd", "diff_attention_interleaved_bwd", "attention_fwd",
                         "attention_bwd"):
            rows = sites if r["name"] in KERNELS else bwd_sites
            r["preset_sites"] = preset_sites([x for x in rows if x["kernel"] == r["name"] and "ms" in x])
        if r["name"] in ("diff_attention_interleaved_fwd", "diff_attention_interleaved_bwd"):
            # phase 6k: the sites past head dim 128, each at its path's batch, and
            # the head dims of every K1/K3 call in its runs
            keys = ("site", "batch", "d", "dv", "ms", "device_ms", "plain_ms", "library_ms", "library_backend",
                    "bound_ms", "bound_by", "roofline_share", "device_roofline_share", "design_flops_factor",
                    "exp_ms", "repeat_bit_identical")
            rows = wide_fwd if r["name"] in KERNELS else wide_bwd
            r["wide_sites"] = [{k: x[k] for k in keys} for x in rows]
            r["wide_widths"] = wide_widths
    records += [record(name, spec, [r for r in swap_rows if r["kernel"] == name], swap_errs[name],
                       weight=lambda r: r["calls_per_forward"])
                for name, spec in SWAP_KERNELS.items() if name != "rotary"]
    records.append(record("rotary", SWAP_KERNELS["rotary"], [rotary_row], rotary_row["max_abs_err"],
                          weight=lambda r: ROTARY_PER_FORWARD["rotary"]))
    check(all(r["launches"] > 0 for r in records), f"a kernel was not launched on its path: {records}")
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
