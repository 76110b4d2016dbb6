"""Smoke run of the PyTorch/CUDA port on one card: build, check, drive, report.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports nothing of JAX. Two main paths
run: volume inference and training. Phases:

1. print the card's name and power limit, and build every kernel of both paths
   from ``cenet_tpu_torch/csrc`` (one ``nvcc`` per source, all in parallel);
2. hold each forward kernel against its plain PyTorch twin at every main-path
   shape (batch 2; fp32 with TF32 off and bf16), then at a 32-slice chunk in
   bf16 (against the twin in slices of 2), and time kernel, twin and the
   PyTorch library call there;
   2b. the same for the backward kernels (dq, dk, dv, in max-abs and in norm,
   and dλ for the diff kernel) at batch 2; at the training batch of 8, at the
   sites it routes, forward and backward kernels in fp32 and bf16 against the
   twins in slices of 2, and the backward's times in bf16;
3. slice parity: a seeded CENet-b2 (Synapse preset) on 2 slices at 224², fp32
   on the card (kernels routed) against fp32 on the CPU (twins), then bf16;
   3b. train-step parity: one fp32 forward/backward of the same model in train
   mode on 2 labelled images, card (kernels) and CPU (twins) each against the
   same step in float64 on the CPU; then at batch 8 the card's kernels against
   its twins;
4. the volume path: ``VolumeInferencer`` + ``run_inference`` in bf16 on two
   seeded synthetic CT cases (64 × 512 × 512, labels 0–8), with the kernel
   launch counts of that run;
5. where one chunk's time goes: the bf16 forward of 32 slices timed with CUDA
   events, and its device time by kernel from ``torch.profiler``;
6. the training path: 64 synthetic 512² slices written as ``.npz`` with a
   ``train.txt``, then ``SynapseDataset`` → ``Loader`` → ``Trainer.train_step``
   with the Synapse preset (batch 8, bf16, SGD poly, BoundaryDoU, drop-path
   0.1): img/s through the loader, the wait on it, the step's wall time on a
   resident batch, every loss, peak memory and the launch counts of the run;
7. where one training step's time goes: ``torch.profiler`` over one bf16 step
   (the card's busy time, and the host's).

Any failed phase raises, so the exit code is not 0 and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``; the two before it
hold the per-kernel record and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
        want_w = plain_fn(kernel)(args[0].float(), args[1].float(), *args[2:])[0]
        lim = bf16_o_limit(want[0], want_w)
        out["w_term"], out["err_o_vs_w_rounded"] = amax(want_w - want[0]), amax(got[0].float() - want_w)
    out["limit_o"], out["share_o"] = lim, e_o / lim
    check(e_o <= lim and e_l <= TOL_FP32,
          f"{kernel} at {where}: o err {e_o} (limit {lim}), lse err {e_l} (limit {TOL_FP32})")
    return out


# Main-path sites of a Synapse chunk: (site, kernel, h, n, d, dv). Diff attention:
# q/k (B, 2h, N, d), v (B, h, N, 2d); attention: q/k (B, h, N, d), v (B, h, N, dv).
SITES = [
    ("DSEB1", "diff_attention_interleaved_fwd", 8, 3136, 8, 16),
    ("DSEB2", "diff_attention_interleaved_fwd", 8, 784, 16, 32),
    ("DSEB3", "diff_attention_interleaved_fwd", 16, 196, 20, 40),
    ("dec1", "attention_fwd", 1, 3136, 64, 64),
    ("dec2", "attention_fwd", 1, 784, 128, 128),
]
KERNELS = {
    "diff_attention_interleaved_fwd": dict(
        source="cenet_tpu_torch/csrc/diff_attention_fwd.cu",
        replaces="cenet_tpu/ops/pallas_attention.py:826 (_diff_fwd_pair_impl)", per_chunk=3),
    "attention_fwd": dict(
        source="cenet_tpu_torch/csrc/attention_fwd.cu",
        replaces="cenet_tpu/ops/pallas_attention.py:90 (_pallas_attention_fwd_impl)", per_chunk=2),
}
# backward kernels and the forward kernel each differentiates
BWD_KERNELS = {
    "diff_attention_interleaved_bwd": dict(
        source="cenet_tpu_torch/csrc/diff_attention_bwd.cu", fwd="diff_attention_interleaved_fwd",
        replaces="cenet_tpu/ops/pallas_attention.py:865 (_diff_bwd_pair_impl)"),
    "attention_bwd": dict(
        source="cenet_tpu_torch/csrc/attention_bwd.cu", fwd="attention_fwd",
        replaces="cenet_tpu/ops/pallas_attention.py:261 (_pallas_attention_bwd_impl)"),
}
# launches per training step at B=8 (DSEB1, DSEB2 and dec1 are routed; DSEB3
# and dec2 only from B=14), and at B=2 in phase 3b, where the same three are
TRAIN_PER_STEP = {"diff_attention_interleaved_fwd": 2, "attention_fwd": 1,
                  "diff_attention_interleaved_bwd": 2, "attention_bwd": 1}
TRAIN_SITES = ("DSEB1", "DSEB2", "dec1")  # routed at the training batch


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def site_inputs(kernel, b, h, n, d, dv, dtype, gen):
    """Inputs laid out as the model hands them over: the diff-attention q/k/v are
    transposed views of (B, N, heads, d) projections; q is pre-scaled."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    if kernel == "diff_attention_interleaved_fwd":
        q = (rnd(b, n, 2 * h, d) * d**-0.5).transpose(1, 2)
        return q, rnd(b, n, 2 * h, d).transpose(1, 2), rnd(b, n, h, dv).transpose(1, 2), torch.tensor(0.2, device=DEV)
    return rnd(b, h, n, d) * d**-0.5, rnd(b, h, n, d), rnd(b, h, n, dv)


def kernel_fn(kernel):
    return K.diff_attention_interleaved_fwd if kernel == "diff_attention_interleaved_fwd" else K.attention_fwd


def plain_fn(kernel):
    return K.diff_attention_interleaved_fwd_plain if kernel == "diff_attention_interleaved_fwd" else K.attention_fwd_plain


def library_fn(kernel, args):
    """One PyTorch library computation of the same function (timed as a yardstick only)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kernel == "diff_attention_interleaved_fwd":
        q, k, v, lam = args
        return lambda: sdpa(q[:, 0::2], k[:, 0::2], v, scale=1.0) - lam * sdpa(q[:, 1::2], k[:, 1::2], v, scale=1.0)
    q, k, v = args
    return lambda: sdpa(q, k, v, scale=1.0)


def bound(kernel, b, h, n, d, dv, itemsize):
    """(ms for the operations, ms for the bytes): FLOPs over the bf16 peak, and
    bytes (inputs read once, outputs written once) over the memory rate."""
    groups = 2 if kernel == "diff_attention_interleaved_fwd" else 1
    flops = b * h * (groups * 2 * n * n * d + 2 * n * n * dv)
    nbytes = itemsize * b * (groups * h * n * d * 2 + h * n * dv * 2) + 4 * b * h * n * groups
    return flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_by(t_ops, t_bytes):
    return "operations" if t_ops >= t_bytes else "bytes"


def phase_kernels():
    """Kernel vs twin at batch 2 (fp32, bf16), then at a 32-slice chunk (bf16,
    held against the twin in slices of 2) with times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    sites = []
    for site, kernel, h, n, d, dv in SITES:
        row = {"site": site, "kernel": kernel}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = site_inputs(kernel, 2, h, n, d, dv, dtype, gen)
            got = kernel_fn(kernel)(*args)
            row.update({f"{label}_{k}": v for k, v in fwd_check(kernel, args, got, f"{site} {label}").items()})
            if label == "bf16":
                errs[kernel] = max(errs[kernel], row["bf16_err_o"])
        args2 = site_inputs(kernel, 2, h, n, d, dv, torch.bfloat16, gen)
        row["plain_ms_b2"] = time_ms(lambda: plain_fn(kernel)(*args2), reps=3)
        args = site_inputs(kernel, CHUNK, h, n, d, dv, torch.bfloat16, gen)
        got = kernel_fn(kernel)(*args)
        row.update({f"chunk_{k}": v for k, v in
                    in_slices(fwd_check, kernel, args, got, f"{site} bf16 chunk of {CHUNK}").items()})
        errs[kernel] = max(errs[kernel], row["chunk_err_o"])
        del got
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
    the input dtype for the attention kernel) from the fp32 twin (in slices of
    2), and a strided dO."""
    fwd = BWD_KERNELS[kernel]["fwd"]
    args = site_inputs(fwd, b, h, n, d, dv, dtype, gen)
    do = torch.randn(b, n, h, dv, generator=gen, device=DEV).to(dtype).transpose(1, 2)
    fw = [torch.cat(parts) for parts in
          zip(*[plain_fn(fwd)(*[a.float() for a in piece(args, i)]) for i in range(0, b, 2)])]
    if kernel == "diff_attention_interleaved_bwd":
        q, k, v, lam = args
        return args, (q, k, v, lam, fw[1], fw[2], do)
    q, k, v = args
    return args, (q, k, v, fw[0].to(dtype), fw[1], do)


def bwd_kernel_fn(kernel):
    return K.diff_attention_interleaved_bwd if kernel == "diff_attention_interleaved_bwd" else K.attention_bwd


def bwd_plain_fn(kernel):
    return K.diff_attention_interleaved_bwd_plain if kernel == "diff_attention_interleaved_bwd" else K.attention_bwd_plain


def bwd_refs(kernel, call):
    """(want, want_r): the twin on fp32 copies of the inputs, and per gradient the
    twin that rounds ds (dq: to k's dtype, dk: to q's) or p/w (dv: to dO's dtype)
    as the kernel does but keeps the gradient itself in fp32."""
    plain = bwd_plain_fn(kernel)
    if kernel == "diff_attention_interleaved_bwd":
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
    """Hold a backward kernel's dq, dk, dv (``got``) against the twin on the same
    inputs, in max-abs and in norm (``grad_limits``); raises past a limit.
    Returns the readings, with the twin's dλ for the diff kernel."""
    dtype = call[0].dtype
    want, want_r = bwd_refs(kernel, call)
    out = {}
    for name, g, w, r, (lim, nlim) in zip(("dq", "dk", "dv"), got, want, want_r, grad_limits(dtype, want[:3], want_r)):
        e, ne = amax(g.float() - w), rel_norm(g, w)
        out.update({f"{name}_err": e, f"{name}_limit": lim, f"{name}_share": e / lim, f"{name}_norm_err": ne,
                    f"{name}_norm_limit": nlim, f"{name}_norm_share": ne / nlim, f"{name}_max_abs": amax(w)})
        if dtype == torch.bfloat16:
            out[f"{name}_round_term"], out[f"{name}_norm_round_term"] = amax(r.float() - w), rel_norm(r, w)
        check(g.dtype == dtype and e <= lim and ne <= nlim,
              f"{kernel} at {where}: {name} err {e} (limit {lim}), norm err {ne} (limit {nlim})")
    if kernel == "diff_attention_interleaved_bwd":
        out["dlam_want"] = float(want[3])
    return out


def dlam_check(got, want, where):
    """dλ is fp32 in both dtypes: one sum over the per-row δ₂ in another order,
    so 1e-4 of max(1, |dλ|). Returns the error."""
    e, lim = abs(float(got) - want), TOL_FP32 * max(1.0, abs(want))
    check(e <= lim, f"diff_attention_interleaved_bwd at {where}: dlam err {e} (limit {lim})")
    return e


def bwd_library_fn(kernel, call):
    """The backward of ``scaled_dot_product_attention`` through autograd on the
    same inputs and dO (for the diff kernel, of the two-call composition); a
    yardstick the port never calls."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = [t.detach().requires_grad_() for t in call[:3]]
    do = call[-1]
    if kernel == "diff_attention_interleaved_bwd":
        lam = call[3]
        o = sdpa(q[:, 0::2], k[:, 0::2], v, scale=1.0) - lam * sdpa(q[:, 1::2], k[:, 1::2], v, scale=1.0)
    else:
        o = sdpa(q, k, v, scale=1.0)
    return lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)


def bwd_bound(kernel, b, h, n, d, dv, itemsize):
    """(ms for the operations, ms for the bytes) of the least backward work:
    FLOPs 2·N·M·(6d + 2dv) per head pair for the diff kernel (s₁, s₂, G, dq₁₂,
    dk₁₂, dv), 2·N·M·(3d + 2dv) per head for attention (s, dP, dq, dk, dv); bytes
    of q, k, v, dO (and o, which Δ needs) and the LSEs read once, dq, dk, dv
    written once."""
    if kernel == "diff_attention_interleaved_bwd":
        flops = b * h * 2 * n * n * (6 * d + 2 * dv)
        nbytes = itemsize * b * (4 * 2 * h * n * d + 3 * h * n * dv) + 4 * b * h * n * 2
    else:
        flops = b * h * 2 * n * n * (3 * d + 2 * dv)
        nbytes = itemsize * b * h * (4 * n * d + 4 * n * dv) + 4 * b * h * n
    return flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_bwd_kernels():
    """Backward kernel vs twin at every main-path shape at batch 2 (fp32, bf16);
    then, at the sites the training batch of 8 routes, the forward and backward
    kernels at that batch in bf16, held against the twins in slices of 2, and
    timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {k: 0.0 for k in BWD_KERNELS}
    fwd_errs = {k: 0.0 for k in KERNELS}
    sites = []
    for site, fwd, h, n, d, dv in SITES:
        kernel = next(k for k, spec in BWD_KERNELS.items() if spec["fwd"] == fwd)
        row = {"site": site, "kernel": kernel}
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            _, call = bwd_call_args(kernel, 2, h, n, d, dv, dtype, gen)
            got = bwd_kernel_fn(kernel)(*call)
            r = bwd_check(kernel, call, got[:3], f"{site} {label}")
            if kernel == "diff_attention_interleaved_bwd":
                r["dlam_err"] = dlam_check(got[3], r["dlam_want"], f"{site} {label}")
            row.update({f"{label}_{k}": v for k, v in r.items()})
            if label == "bf16":
                errs[kernel] = max(errs[kernel], r["dq_err"], r["dk_err"], r["dv_err"])
            del call, got
        torch.cuda.empty_cache()
        if site in TRAIN_SITES:
            for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                where, key = f"{site} {label} batch {TRAIN_B}", f"b{TRAIN_B}_{label}"
                args, call = bwd_call_args(kernel, TRAIN_B, h, n, d, dv, dtype, gen)
                got = kernel_fn(fwd)(*args)
                row.update({f"{key}_fwd_{k}": v for k, v in in_slices(fwd_check, fwd, args, got, where).items()})
                got = bwd_kernel_fn(kernel)(*call)
                r = in_slices(bwd_check, kernel, call, got[:3], where)
                if kernel == "diff_attention_interleaved_bwd":
                    r["dlam_err"] = dlam_check(got[3], r["dlam_want"], where)
                row.update({f"{key}_{k}": v for k, v in r.items()})
                del got
            fwd_errs[fwd] = max(fwd_errs[fwd], row[f"b{TRAIN_B}_bf16_fwd_err_o"])
            errs[kernel] = max(errs[kernel], *(row[f"b{TRAIN_B}_bf16_{g}_err"] for g in ("dq", "dk", "dv")))
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
    check(all(launched[k] > 0 for k in KERNELS), f"the fp32 forward launched no kernel: {launched}")
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
    base = get_preset("synapse")
    cfg = base.replace(model=dataclasses.replace(base.model, drop_path_rate=0.0),
                       train=dataclasses.replace(base.train, amp=False))
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

    def summary(errs):
        top = sorted(errs.items(), key=lambda kv: kv[1], reverse=True)
        return {"picked": {n: errs[n] for n in PARITY_GRADS}, "median": float(np.median(list(errs.values()))),
                "above_1e-4": sum(e > 1e-4 for e in errs.values()), "top": top[:6]}

    losses = {"card_kernels": float(loss), "card_twins": float(plain_loss), "card_kernels_native_conv":
              float(native_loss), "cpu": float(cpu_loss), "float64": float(w_loss)}
    emit({"phase": "train_parity", "batch": 2, "losses": losses, "parameters": len(names),
          "compared": len(live),
          "grad_rel_err_vs_float64": {run: summary(e) for run, e in vs_f64.items()},
          "grad_rel_err_card_kernels_vs_cpu": summary(vs_cpu),
          "grad_rel_err_card_kernels_native_conv_vs_cpu": summary(native_vs_cpu),
          "grad_rel_err_kernels_vs_twins": summary(own),
          "cpu_s": cpu_s, "float64_s": witness_s, "launches_card": launched})
    for name, per_step in TRAIN_PER_STEP.items():
        check(launched[name] == per_step, f"train parity: {name} launched {launched[name]} times, expected {per_step}")
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
    for name, per_step in TRAIN_PER_STEP.items():
        check(launched[name] == per_step,
              f"train parity, batch {TRAIN_B}: {name} launched {launched[name]} times, expected {per_step}")
    median = float(np.median(list(own.values())))
    check(median <= TOL_B8_MEDIAN, f"train parity, batch {TRAIN_B}: the kernels move the gradients by a median {median}")
    for n, (_, _, lim) in PARITY_GRADS.items():
        check(own[n] <= lim,
              f"train parity, batch {TRAIN_B}: the kernels move the gradient of {n} by {own[n]} of its max (limit {lim})")
    del card, grads, plain_grads, native_grads
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
    for name, spec in KERNELS.items():
        check(launches[name] == spec["per_chunk"] * chunks,
              f"{name} launched {launches[name]} times over {chunks} chunks, expected {spec['per_chunk']} per chunk")
    return launches


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
    for name, per_step in TRAIN_PER_STEP.items():
        check(launches[name] == per_step * steps,
              f"{name} launched {launches[name]} times over {steps} steps, expected {per_step} per step")
    return launches, trainer, images, labels


def phase_train_profile(trainer, images, labels, top=15):
    """Where one bf16 training step's device time goes (``torch.profiler``)."""
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
    # the host side: operators by their own CPU time (what the Python thread spends
    # issuing the step)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    emit({"phase": "train_profile", "step_wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms, "kernel_names": len(kernels),
          "kernel_launches": sum(e.count for e in kernels),
          "top": [{"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                  for e in kernels[:top]],
          "host_ops": sum(e.count for e in host), "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
          "top_host": [{"name": e.key[:80], "calls": e.count, "self_ms": e.self_cpu_time_total / 1e3}
                       for e in host[:top]]})


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build(["diff_attention_fwd", "attention_fwd", "diff_attention_bwd", "attention_bwd"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "dir": str(build._build_dir())})

    sites, errs = phase_kernels()
    bwd_sites, bwd_errs, train_fwd_errs = phase_bwd_kernels()
    errs = {k: max(e, train_fwd_errs[k]) for k, e in errs.items()}
    phase_slice_parity()
    phase_train_parity()
    launches = phase_volume()
    phase_profile()
    train_launches, trainer, images, labels = phase_train()
    phase_train_profile(trainer, images, labels)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})

    def record(name, spec, rows, path, launched, err):
        return {
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "path": path, "launches": launched[name], "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": bound_by(sum(r["ops_ms"] for r in rows), sum(r["bytes_ms"] for r in rows)),
            "library_ms": sum(r["library_ms"] for r in rows),
        }

    # forward kernels: launches of the volume path, times for one 32-slice chunk
    # (the sum over their sites); backward kernels: launches of the training path,
    # times for one training step at B=8 (the sum over the sites it routes)
    records = [record(name, spec, [r for r in sites if r["kernel"] == name], "volume", launches, errs[name])
               for name, spec in KERNELS.items()]
    records += [record(name, spec, [r for r in bwd_sites if r["kernel"] == name and "ms" in r], "train",
                       train_launches, bwd_errs[name]) for name, spec in BWD_KERNELS.items()]
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
