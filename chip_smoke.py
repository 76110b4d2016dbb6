"""Smoke run of the PyTorch/CUDA port on one card: build, check, drive, report.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports nothing of JAX. Two main paths
run, volume inference and training, each on two routes of the DSEB sites'
diff attention: the interleaved route (K1, K3) the model takes, and the
split-group route (K5, K6) of ``router.diff_attention_core``, selected here by
rebinding ``router.diff_attention_interleaved`` (``split_route``). Phases:

1. print the card's name and power limit, and build every kernel of both paths
   from ``cenet_tpu_torch/csrc`` (one ``nvcc`` per source, all in parallel);
2. hold each forward kernel (K1, K2, K5) against its plain PyTorch twin at
   every main-path shape (batch 2; fp32 with TF32 off and bf16), then at a
   32-slice chunk in bf16 (against the twin in slices of 2), K5 also against
   K1 on the same inputs, and time kernel, twin and the PyTorch library call
   there;
   2b. the same for the backward kernels (K3, K4 at every site; K6, K7 at the
   DSEB sites and K8 at the dec1 site that training routes) on their gradients,
   in max-abs and in norm, and dλ for the diff kernels, at batch 2; at the
   training batch of 8, forward and backward kernels in fp32 and bf16 against
   the twins in slices of 2, the backward's times in bf16, and whether two
   runs on the same inputs are bit-identical;
3. slice parity: a seeded CENet-b2 (Synapse preset) on 2 slices at 224², fp32
   on the card (kernels routed) against fp32 on the CPU (twins), then bf16;
   3b. train-step parity: one fp32 forward/backward of the same model in train
   mode on 2 labelled images, card (kernels) and CPU (twins) each against the
   same step in float64 on the CPU; then at batch 8 the card's kernels against
   its twins;
   3c. the split route's train step: one fp32 step at batch 8 on the split
   route (K5, K6) against the interleaved route from the same weights and
   batch, then the same with K7 and K8 swapped in for K6 and K4;
4. the volume path: ``VolumeInferencer`` + ``run_inference`` in bf16 on two
   seeded synthetic CT cases (64 × 512 × 512, labels 0–8), with the kernel
   launch counts of that run;
   4b. the split route's volume path: one bf16 chunk through ``make_predict_fn``
   and one synthetic case through ``VolumeInferencer`` on both routes, with
   the split run's launch counts and slices/s;
5. where one chunk's time goes: the bf16 forward of 32 slices timed with CUDA
   events, and its device time by kernel from ``torch.profiler``;
6. the training path: 64 synthetic 512² slices written as ``.npz`` with a
   ``train.txt``, then ``SynapseDataset`` → ``Loader`` → ``Trainer.train_step``
   with the Synapse preset (batch 8, bf16, SGD poly, BoundaryDoU, drop-path
   0.1): img/s through the loader, the wait on it, the step's wall time on a
   resident batch, every loss, peak memory and the launch counts of the run;
7. where one training step's time goes: ``torch.profiler`` over one bf16 step
   (the card's busy time, and the host's);
   7b. ten resident bf16 steps of phase 6's trainer on the split route: step
   ms, launch counts, and one profiled step beside phase 7's.

Any failed phase raises, so the exit code is not 0 and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``; the two before it
hold the per-kernel record and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

from cenet_tpu_torch.core.config import get_preset  # noqa: E402
from cenet_tpu_torch.data import augment  # noqa: E402
from cenet_tpu_torch.data.loader import Loader, device_put_fn  # noqa: E402
from cenet_tpu_torch.data.synapse import SynapseDataset  # noqa: E402
from cenet_tpu_torch.evaluate.predict import make_predict_fn  # noqa: E402
from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer, run_inference  # noqa: E402
from cenet_tpu_torch.models.cenet import build_model  # noqa: E402
from cenet_tpu_torch.ops import attention_kernels as K  # noqa: E402
from cenet_tpu_torch.ops import build, router  # noqa: E402
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
DIFF_SITES = [("DSEB1", 8, 3136, 8, 16), ("DSEB2", 8, 784, 16, 32), ("DSEB3", 16, 196, 20, 40)]
ATTN_SITES = [("dec1", 1, 3136, 64, 64), ("dec2", 1, 784, 128, 128)]
TRAIN_SITES = ("DSEB1", "DSEB2", "dec1")  # routed at the training batch of 8
# (site, kernel, h, n, d, dv) for phase 2 and phase 2b
SITES = ([(s, "diff_attention_interleaved_fwd", *dims) for s, *dims in DIFF_SITES]
         + [(s, "attention_fwd", *dims) for s, *dims in ATTN_SITES]
         + [(s, "diff_attention_fwd", *dims) for s, *dims in DIFF_SITES])
BWD_SITES = ([(s, "diff_attention_interleaved_bwd", *dims) for s, *dims in DIFF_SITES]
             + [(s, "attention_bwd", *dims) for s, *dims in ATTN_SITES]
             + [(s, k, *dims) for k in ("diff_attention_bwd", "diff_attention_bwd_split")
                for s, *dims in DIFF_SITES if s in TRAIN_SITES]
             + [(s, "attention_bwd_fused", *dims) for s, *dims in ATTN_SITES if s in TRAIN_SITES])
PALLAS = "cenet_tpu/ops/pallas_attention.py"
# ``path``: the run whose launch counts the kernels line reports
KERNELS = {
    "diff_attention_interleaved_fwd": dict(
        source="cenet_tpu_torch/csrc/diff_attention_fwd.cu", replaces=f"{PALLAS}:826 (_diff_fwd_pair_impl)",
        path="volume"),
    "attention_fwd": dict(
        source="cenet_tpu_torch/csrc/attention_fwd.cu", replaces=f"{PALLAS}:90 (_pallas_attention_fwd_impl)",
        path="volume"),
    "diff_attention_fwd": dict(
        source="cenet_tpu_torch/csrc/diff_attention_split_fwd.cu", replaces=f"{PALLAS}:360 (_diff_fwd_impl)",
        path="volume-split"),
}
# backward kernels and the forward kernel each differentiates
BWD_KERNELS = {
    "diff_attention_interleaved_bwd": dict(
        source="cenet_tpu_torch/csrc/diff_attention_bwd.cu", fwd="diff_attention_interleaved_fwd",
        replaces=f"{PALLAS}:865 (_diff_bwd_pair_impl)", path="train"),
    "attention_bwd": dict(
        source="cenet_tpu_torch/csrc/attention_bwd.cu", fwd="attention_fwd",
        replaces=f"{PALLAS}:261 (_pallas_attention_bwd_impl)", path="train"),
    "diff_attention_bwd": dict(
        source="cenet_tpu_torch/csrc/diff_attention_split_bwd.cu", fwd="diff_attention_fwd",
        replaces=f"{PALLAS}:545 (_diff_bwd_onekernel_impl)", path="train-split"),
    "diff_attention_bwd_split": dict(
        source="cenet_tpu_torch/csrc/diff_attention_split_bwd_two_kernel.cu", fwd="diff_attention_fwd",
        replaces=f"{PALLAS}:609 (_diff_bwd_impl)", path="train-split (swapped)"),
    "attention_bwd_fused": dict(
        source="cenet_tpu_torch/csrc/attention_bwd_fused.cu", fwd="attention_fwd",
        replaces=f"{PALLAS}:212 (_pallas_attention_bwd_fused_impl)", path="train-split (swapped)"),
}
SPLIT_BWD = ("diff_attention_bwd", "diff_attention_bwd_split")
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


def bound(kernel, b, h, n, d, dv, itemsize):
    """(ms for the operations, ms for the bytes): FLOPs over the bf16 peak, and
    bytes (inputs read once, outputs written once) over the memory rate."""
    groups = 2 if kernel in ("diff_attention_interleaved_fwd", "diff_attention_fwd") else 1
    flops = b * h * (groups * 2 * n * n * d + 2 * n * n * dv)
    nbytes = itemsize * b * (groups * h * n * d * 2 + h * n * dv * 2) + 4 * b * h * n * groups
    return flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


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
    from: the same arithmetic, held to the twin's limits. Returns the readings."""
    pair = K.diff_attention_interleaved_fwd(*inter)
    e_o = amax(got[0].float() - pair[0].float())
    e_l = max(amax(g - p) for g, p in zip(got[1:], pair[1:]))
    check(e_o <= lim and e_l <= TOL_FP32, f"diff_attention_fwd against K1 at {where}: o {e_o} (limit {lim}), "
          f"lse {e_l} (limit {TOL_FP32})")
    return {"vs_k1_err_o": e_o, "vs_k1_err_lse": e_l}


def phase_kernels():
    """Kernel vs twin at batch 2 (fp32, bf16), then at a 32-slice chunk (bf16,
    held against the twin in slices of 2) with times; K5 also against K1."""
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
        del got, inter
        row["ms"] = time_ms(lambda: kernel_fn(kernel)(*args))
        # the twin's N×N maps at B=32 do not fit at once: time it over the same
        # inputs in slices of 2
        row["plain_ms"] = time_ms(lambda: [plain_fn(kernel)(*piece(args, i)) for i in range(0, CHUNK, 2)], reps=1)
        row["library_ms"] = time_ms(library_fn(kernel, args))
        row["ops_ms"], row["bytes_ms"] = bound(kernel, CHUNK, h, n, d, dv, 2)
        row["bound_ms"], row["bound_by"] = max(row["ops_ms"], row["bytes_ms"]), bound_by(row["ops_ms"], row["bytes_ms"])
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        del args, args2
        torch.cuda.empty_cache()
        emit({"phase": "kernels", **row})
        sites.append(row)
    K.reset_launches()
    return sites, errs


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


def bwd_site_check(kernel, call, where):
    """Run a backward kernel on ``call`` and hold it against its twin (in slices
    of 2), dλ included for the diff kernels. Returns the readings."""
    got = bwd_kernel_fn(kernel)(*call)
    n = len(grad_names(kernel))
    r = in_slices(bwd_check, kernel, call, got[:n], where)
    if kernel in DIFF_BWD:
        r["dlam_err"] = dlam_check(kernel, got[n], r["dlam_want"], where)
    return r


def phase_bwd_kernels():
    """Backward kernel vs twin at batch 2 (fp32, bf16) at its sites; then, at the
    sites the training batch of 8 routes, the forward and backward kernels at
    that batch in fp32 and bf16, held against the twins in slices of 2, and the
    backward timed in bf16."""
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
# (PERF.md, phase 3b).
PARITY_GRADS = {
    "decoder.skip_enhancer1.diffattn.q_proj.weight": (6e-3, 3e-3, 3e-4),
    "decoder.skip_enhancer1.diffattn.lambda_q1": (3.2e-2, 6e-3, 1.5e-3),
    "decoder.dec1.mca.denoising_module.conv_theta.weight": (2e-3, 1e-3, 4e-5),
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
    del cpu, witness, grads, plain_grads, native_grads, cpu_grads, w_grads

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
    return live


def phase_split_train_parity(live):
    """One fp32 train step at the training batch of 8 (TF32 off, drop-path off)
    on the split route against the interleaved route, from the same weights and
    batch: the loss within ``TOL_LOSS``, the gradients (over phase 3b's
    parameters) within phase 3b's batch-8 limits of kernels against twins (the
    two routes differ in fp32 summation order only: K6's dv sums P₁ᵀdO and
    P₂ᵀdO apart, and adds over query tiles with atomics). Then the same step
    with K7 and K8 in place of K6 and K4. Returns each run's launch counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = labelled_slices(11, TRAIN_B, 224)
    x, y = x.to(DEV), y.to(DEV)
    card = Trainer(parity_config(), 1, device=DEV, model_seed=0)
    card.model.train()
    loss, grads = card.loss_and_grads(x, y)
    names = [n for n, _ in card.model.named_parameters()]
    launches = {}
    for route, swap in (("split", False), ("split, K7 and K8", True)):
        K.reset_launches()
        with split_route(swap_backwards=swap):
            s_loss, s_grads = card.loss_and_grads(x, y)
        torch.cuda.synchronize()
        launches[route] = launched = dict(K.LAUNCHES)
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
    return launches


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


def phase_volume():
    """The main path: bf16 volume inference with metrics; returns the launch counts."""
    cfg = get_preset("synapse")
    model = build_model(cfg, device=DEV, seed=0)
    inf = VolumeInferencer(make_predict_fn(model, torch.bfloat16),
                           VolumeInferenceConfig(img_size=224, chunk=CHUNK, num_classes=9), device=DEV)
    cases = [synthetic_case(1), synthetic_case(2)]
    inf.predict_volume(cases[0]["image"][:CHUNK])  # warm-up: cuDNN plans, matrices, kernel loads

    # host clocks around the volume and around each chunk; both return host
    # labels, so the device work inside has finished when the clock stops
    spent = {"predict_volume": 0.0, "_predict_chunk": 0.0}

    def timed(name):
        fn = getattr(inf, name)

        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] += time.perf_counter() - t0
            return out

        setattr(inf, name, run)

    timed("predict_volume")
    timed("_predict_chunk")
    K.reset_launches()
    dice, hd95 = run_inference(inf, cases)
    launches = dict(K.LAUNCHES)
    slices = sum(c["image"].shape[0] for c in cases)
    chunks = sum(-(-c["image"].shape[0] // CHUNK) for c in cases)
    predict_s, chunk_s = spent["predict_volume"], spent["_predict_chunk"]
    emit({"phase": "volume", "cases": len(cases), "slices": slices, "chunks": chunks,
          "slices_per_s": slices / predict_s, "predict_s": predict_s,
          # upload, device zoom, forward, argmax and copy back, per chunk
          "chunk_ms": chunk_s / chunks * 1e3,
          # padding, concatenation and the host order-0 back-zoom, per chunk
          "host_ms": (predict_s - chunk_s) / chunks * 1e3,
          "mean_dice": dice, "mean_hd95": hd95,
          "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(np.isfinite(dice) and np.isfinite(hd95) and 0.0 <= dice <= 1.0, f"metrics {dice}, {hd95}")
    check_launches(launches, VOLUME_PER_CHUNK["interleaved"], chunks, f"volume, {chunks} chunks")
    return launches


def phase_split_volume():
    """The volume path on the split route against the interleaved route: one bf16
    32-slice chunk through ``make_predict_fn`` (probabilities within phase 3's
    1e-3, argmax agreement ≥ 99.9%), then a synthetic 64-slice case through
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
          "case_label_agree": label_agree, "slices": int(image.shape[0]), "chunks": chunks,
          "slices_per_s": {r: [image.shape[0] / t for t in ts] for r, ts in seconds.items()},
          "launches_split": split_launches})
    check(diff <= 1e-3 and agree >= 0.999, f"split volume: chunk probabilities off by {diff}, argmax agreement {agree}")
    check(label_agree >= 0.999, f"split volume: labels agree on {label_agree} of the case")
    del model
    torch.cuda.empty_cache()
    return split_launches


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
    emit({"phase": "profile", "forward_ms": forward_ms, "device_busy_ms": busy_ms, "kernel_names": len(kernels),
          "top": [{"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                  for e in kernels[:top]]})
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


def phase_train(warmup=3, steps=30):
    """The training path: ``SynapseDataset`` → ``Loader`` → ``Trainer.train_step``
    with the Synapse preset as it stands; returns the launch counts of the timed
    steps, a device-resident batch and the trainer."""
    cfg = get_preset("synapse")
    with tempfile.TemporaryDirectory() as root:
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
    return launches, trainer, images, labels


# the diff-attention kernels' roles by their symbols (csrc/attention_{fwd,bwd}_common.cuh,
# GROUPS = 2): forward (K1 or K5), dq and dk/dv of the two-launch backwards (K3,
# K7), the one-launch backward (K6)
DIFF_KERNEL_ROLES = {"fwd": r"attention_fwd_kernel<[^,<>]+, 2,",
                     "bwd_dq": r"attention_bwd_dq_kernel<[^,<>]+, 2, \d+, false>",
                     "bwd_dkv": r"attention_bwd_dkv_kernel<[^,<>]+, 2,",
                     "bwd_one_launch": r"attention_bwd_dq_kernel<[^,<>]+, 2, \d+, true>"}


def profile_step(trainer, images, labels, top=15):
    """``torch.profiler`` over one training step after one unprofiled step: the
    card's busy time, the diff-attention kernels' device ms by role, the device
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
    roles = {role: sum(e.self_device_time_total for e in kernels if re.search(pat, e.key)) / 1e3
             for role, pat in DIFF_KERNEL_ROLES.items()}
    scatter = [e for e in events if e.key == "aten::slice_backward"]
    # the host side: operators by their own CPU time (what the Python thread spends
    # issuing the step)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"step_wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "kernel_names": len(kernels),
            "kernel_launches": sum(e.count for e in kernels), "diff_attention_ms": roles,
            "slice_backward": {"calls": sum(e.count for e in scatter),
                               "device_ms": sum(e.device_time_total for e in scatter) / 1e3},
            "top": [{"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]],
            "host_ops": sum(e.count for e in host), "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "top_host": [{"name": e.key[:80], "calls": e.count, "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:top]]}


def phase_train_profile(trainer, images, labels):
    """Where one bf16 training step's device time goes (``torch.profiler``)."""
    emit({"phase": "train_profile", **profile_step(trainer, images, labels)})


def phase_split_train(trainer, images, labels, steps=10):
    """Phase 6's bf16 trainer on its resident batch, on the split route: the
    step's ms over ``steps`` steps (CUDA events), their launch counts, and one
    profiled step (K5 and K6 device ms, the head-view gradient scatter) beside
    phase 7's. Returns the launch counts."""
    with split_route():
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
    emit({"phase": "split_train", "steps": steps, "resident_step_ms": start.elapsed_time(end) / steps,
          "launches": launched, "profile": prof})
    check_launches(launched, TRAIN_PER_STEP["split"], steps, f"split train, {steps} steps")
    return launched


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    sources = [os.path.splitext(os.path.basename(spec["source"]))[0] for spec in (*KERNELS.values(), *BWD_KERNELS.values())]
    build.build(sources)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sources, "dir": str(build._build_dir())})

    sites, errs = phase_kernels()
    bwd_sites, bwd_errs, train_fwd_errs = phase_bwd_kernels()
    errs = {k: max(e, train_fwd_errs[k]) for k, e in errs.items()}
    phase_slice_parity()
    live = phase_train_parity()
    split_train_launches = phase_split_train_parity(live)
    launches = {"volume": phase_volume(), "volume-split": phase_split_volume()}
    phase_profile()
    launches["train"], trainer, images, labels = phase_train()
    phase_train_profile(trainer, images, labels)
    launches["train-split"] = phase_split_train(trainer, images, labels)
    launches["train-split (swapped)"] = split_train_launches["split, K7 and K8"]
    emit({"phase": "done", "seconds": time.perf_counter() - t0})

    def record(name, spec, rows, err):
        return {
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "path": spec["path"], "launches": launches[spec["path"]][name], "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": bound_by(sum(r["ops_ms"] for r in rows), sum(r["bytes_ms"] for r in rows)),
            "library_ms": sum(r["library_ms"] for r in rows),
        }

    # forward kernels: launches of their volume path, times for one 32-slice
    # chunk (the sum over their sites); backward kernels: launches of their
    # training path, times for one training step at B=8 (the sum over the sites
    # it routes)
    records = [record(name, spec, [r for r in sites if r["kernel"] == name], errs[name])
               for name, spec in KERNELS.items()]
    records += [record(name, spec, [r for r in bwd_sites if r["kernel"] == name and "ms" in r], bwd_errs[name])
                for name, spec in BWD_KERNELS.items()]
    check(all(r["launches"] > 0 for r in records), f"a kernel was not launched on its path: {records}")
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
