"""Attention kernels for Hopper, with their plain PyTorch twins and autograd Functions.

Mirrors the kernels of ``cenet_tpu/ops/pallas_attention.py``:

* :func:`diff_attention_interleaved_fwd` replaces ``_diff_fwd_pair_impl``
  (``pallas_diff_attention_interleaved``), source ``csrc/diff_attention_fwd.cu``;
* :func:`attention_fwd` replaces ``_pallas_attention_fwd_impl``
  (``pallas_attention``), source ``csrc/attention_fwd.cu``;
* :func:`diff_attention_interleaved_bwd` replaces ``_diff_bwd_pair_impl``, the
  backward of ``pallas_diff_attention_interleaved``, source
  ``csrc/diff_attention_bwd.cu``;
* :func:`attention_bwd` replaces ``_pallas_attention_bwd_impl``, the backward of
  ``pallas_attention``, source ``csrc/attention_bwd.cu``;
* :func:`diff_attention_fwd` replaces ``_diff_fwd_impl`` (``pallas_diff_attention``,
  the split-group route), source ``csrc/diff_attention_split_fwd.cu``;
* :func:`diff_attention_bwd` replaces ``_diff_bwd_onekernel_impl``, the backward
  of ``pallas_diff_attention``, in one launch, source
  ``csrc/diff_attention_split_bwd.cu``;
* :func:`diff_attention_bwd_split` replaces ``_diff_bwd_impl``, the same
  gradients in two launches (no router of either package calls it), source
  ``csrc/diff_attention_split_bwd_two_kernel.cu``;
* :func:`attention_bwd_fused` replaces ``_pallas_attention_bwd_fused_impl``,
  :func:`attention_bwd`'s gradients in one launch (no router calls it), source
  ``csrc/attention_bwd_fused.cu``.

Every kernel launches one of two hand-written designs by dtype: bf16 runs on
the tensor cores (``mma.sync`` on bf16 tiles with fp32 sums;
``csrc/attention_tc.cuh`` for K2, K4 and K8, ``csrc/diff_attention_tc.cuh`` for
K1, K3, K5, K6 and K7, where K5 is K1's kernel on the split head views, K7 K3's
kernels with its own dv rounding and K6 K3's dq kernel that also adds each key
tile's dk and dv partials), fp32 on CUDA cores in fp32 FMA
(``csrc/attention_{fwd,bwd}_common.cuh``), because the tensor cores take fp32
only as TF32. Both keep the Pallas bodies' rounding points. K2 and K4 take head dims up
to 512 (the other kernels 128): past 128 they launch the wide designs of
``csrc/attention_wide.cuh`` in both dtypes (d and dv in 128-column chunks, one
128-column slice of each output a block).

:class:`DiffAttentionInterleavedFn`, :class:`DiffAttentionFn` and
:class:`AttentionFn` pair each routed forward kernel with its backward, as the
``custom_vjp``s of the JAX package do.

Each wrapper takes its plain twin only for tensors on the CPU. For CUDA tensors
it launches the kernel (built at first use by :mod:`cenet_tpu_torch.ops.build`)
or raises; it never falls back. ``LAUNCHES`` (:mod:`cenet_tpu_torch.ops.binding`,
shared by every op module) counts kernel launches by name (one per wrapper
call, however many CUDA kernels the call starts).
The public functions keep the JAX layout: q/k ``(B, 2h, N, d)`` with even heads
group 1, v ``(B, h, M, 2d)`` for the interleaved diff kernel; q₁, q₂ ``(B, h, N, d)``,
k₁, k₂ ``(B, h, M, d)``, v ``(B, h, M, dv)`` for the split one; ``(B, H, N|M, d)``
for plain attention. q is pre-scaled. q, k, v and ``do`` may have any batch,
head and row strides (unit stride on the last dim), passed to the kernels as
they are. The forwards return ``o`` in q's dtype and the fp32 row
log-sum-exp ``(B, h, N)`` (two of them for the diff kernels); the backwards
take the upstream gradient ``do`` with the shape of ``o`` and return the
gradients in the inputs' dtypes, contiguous.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cenet_tpu_torch.ops import binding
from cenet_tpu_torch.ops.binding import LAUNCHES, reset_launches  # noqa: F401  (public names of this module)

_MAX_D, _MAX_DV = 128, 128  # csrc/attention_fwd_common.cuh: MAX_D, MAX_DV
_MAX_WIDE = 512  # K2 and K4 (attention_fwd, attention_bwd): csrc/attention_wide.cuh, wide::MAX_DIM

_P, _I, _L = binding.P, binding.I, binding.L
# C signatures (csrc/*.cu): is_bf16, pointers, B, H, N, M, D, DV, 3 strides per
# strided input, stream
_ARGTYPES = {
    "cenet_diff_attention_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_L] * 9 + [_P],
    "cenet_attention_fwd": [_I] + [_P] * 5 + [_I] * 6 + [_L] * 9 + [_P],
    "cenet_diff_attention_bwd": [_I] + [_P] * 12 + [_I] * 6 + [_L] * 12 + [_P],
    "cenet_attention_bwd": [_I] + [_P] * 9 + [_I] * 6 + [_L] * 12 + [_P],
    "cenet_diff_attention_split_fwd": [_I] + [_P] * 9 + [_I] * 6 + [_L] * 15 + [_P],
    "cenet_diff_attention_split_bwd": [_I] + [_P] * 16 + [_I] * 6 + [_L] * 18 + [_P],
    "cenet_diff_attention_split_bwd_two_kernel": [_I] + [_P] * 16 + [_I] * 6 + [_L] * 18 + [_P],
    "cenet_attention_bwd_fused": [_I] + [_P] * 9 + [_I] * 6 + [_L] * 12 + [_P],
}


# ---------------------------------------------------------------------------
# plain twins (CPU path, and the yardstick the kernels are held against)
# ---------------------------------------------------------------------------


def _row_softmax_parts(q: torch.Tensor, k: torch.Tensor):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    d = e.sum(dim=-1, keepdim=True)
    return e, d, (m + torch.log(d))[..., 0]


def diff_attention_fwd_plain(q1, k1, q2, k2, v, lam) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function of ``_diff_fwd_kernel`` in plain PyTorch: fp32 logits and
    softmax, w = e1/d1 − λ·e2/d2 cast to v's dtype, fp32 product."""
    e1, d1, lse1 = _row_softmax_parts(q1, k1)
    e2, d2, lse2 = _row_softmax_parts(q2, k2)
    w = e1 / d1 - lam.float() * (e2 / d2)
    o = torch.matmul(w.to(v.dtype).float(), v.float())
    return o.to(q1.dtype), lse1, lse2


def diff_attention_interleaved_fwd_plain(q, k, v, lam) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function of ``_diff_fwd_pair_kernel``: the split twin on the two
    groups' head views (the Pallas kernels share that arithmetic)."""
    return diff_attention_fwd_plain(q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2], v, lam)


def attention_fwd_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of ``_attn_fwd_kernel`` in plain PyTorch: fp32 logits and
    softmax, unnormalised e cast to v's dtype, fp32 product divided by the sum."""
    e, d, lse = _row_softmax_parts(q, k)
    o = torch.matmul(e.to(v.dtype).float(), v.float()) / d
    return o.to(q.dtype), lse


def _probs(q, k, lse):
    """P = exp(q·kᵀ − lse) in fp32 from the forward's row log-sum-exp."""
    return torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) - lse[..., None])


def _mm(a, b, dtype):
    """a·b with a rounded to ``dtype`` first, fp32 product (the Pallas kernels' casts)."""
    return torch.matmul(a.to(dtype).float(), b.float())


def _diff_group_grads(qg, kg, lse, g, c):
    """One softmax group of the diff-attention backward as the Pallas kernels
    form it: P_g from the LSE, δ_g = rowsum(P_g∘G), ds_g = P_g(G − δ_g), and in
    fp32 dq_g = c·round(ds_g)·k_g, dk_g = c·round(ds_g)ᵀ·q_g. Returns
    ``(dq_g, dk_g, P_g, δ_g)``."""
    p = _probs(qg, kg, lse)
    delta = (p * g).sum(-1, keepdim=True)
    ds = p * (g - delta)
    return c * _mm(ds, kg, kg.dtype), c * _mm(ds.transpose(-1, -2), qg, qg.dtype), p, delta


def diff_attention_bwd_plain(q1, k1, q2, k2, v, lam, lse1, lse2, do):
    """The function of ``_diff_bwd_onekernel`` (K6) and of ``_diff_dq_kernel`` +
    ``_diff_dkv_kernel`` (K7), which compute the same gradients, in plain
    PyTorch. With G = dO·Vᵀ, per group δ_g = rowsum(P_g∘G), ds_g = P_g(G − δ_g),
    dq_g = c_g·round(ds_g)·k_g, dk_g = c_g·round(ds_g)ᵀ·q_g (c₁ = 1, c₂ = −λ, in
    fp32 before the cast); dv = round(P₁)ᵀ·dO − λ·round(P₂)ᵀ·dO, each P rounded
    to dO's dtype and the difference in fp32; dλ = −Σ δ₂. Returns
    ``(dq1, dk1, dq2, dk2, dv, dlam)`` in the dtypes of the inputs."""
    lam_f = lam.float()
    g = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dq1, dk1, p1, _ = _diff_group_grads(q1, k1, lse1, g, 1.0)
    dq2, dk2, p2, delta2 = _diff_group_grads(q2, k2, lse2, g, -lam_f)
    dv = _mm(p1.transpose(-1, -2), do, do.dtype) - lam_f * _mm(p2.transpose(-1, -2), do, do.dtype)
    return (dq1.to(q1.dtype), dk1.to(k1.dtype), dq2.to(q2.dtype), dk2.to(k2.dtype), dv.to(v.dtype),
            (-delta2.sum()).to(lam.dtype))


def diff_attention_interleaved_bwd_plain(q, k, v, lam, lse1, lse2, do):
    """The function of ``_diff_bwd_pair_kernel`` in plain PyTorch: dq, dk and dλ
    as :func:`diff_attention_bwd_plain` on the two groups' head views, but
    dv = round(P₁ − λP₂)ᵀ·dO (w rounded once). Returns ``(dq, dk, dv, dlam)`` in
    the dtypes of q, k, v, lam."""
    lam_f = lam.float()
    g = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dq1, dk1, p1, _ = _diff_group_grads(q[:, 0::2], k[:, 0::2], lse1, g, 1.0)
    dq2, dk2, p2, delta2 = _diff_group_grads(q[:, 1::2], k[:, 1::2], lse2, g, -lam_f)
    b, h2, n, d = q.shape
    dq = torch.stack((dq1, dq2), dim=2).reshape(b, h2, n, d).to(q.dtype)
    dk = torch.stack((dk1, dk2), dim=2).reshape(b, h2, k.shape[2], d).to(k.dtype)
    dv = _mm((p1 - lam_f * p2).transpose(-1, -2), do, do.dtype).to(v.dtype)
    return dq, dk, dv, (-delta2.sum()).to(lam.dtype)


def attention_bwd_plain(q, k, v, o, lse, do):
    """The function of ``_attn_dq_kernel`` and ``_attn_dkv_kernel`` (K4) and of
    ``_attn_bwd_fused_kernel`` (K8), which compute the same gradients, in plain
    PyTorch: P = exp(q·kᵀ − lse), Δ = rowsum(dO∘o) in fp32, ds = P(dO·vᵀ − Δ),
    dq = round(ds)·k, dk = round(ds)ᵀ·q, dv = round(P)ᵀ·dO. Returns ``(dq, dk, dv)``."""
    p = _probs(q, k, lse)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta)
    dq = _mm(ds, k, k.dtype).to(q.dtype)
    dk = _mm(ds.transpose(-1, -2), q, q.dtype).to(k.dtype)
    dv = _mm(p.transpose(-1, -2), do, do.dtype).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, tensors: dict, dtype: torch.dtype) -> None:
    binding.check_cuda_dtype(name, tensors, dtype)
    for tname, t in tensors.items():
        if t.ndim != 4:
            raise ValueError(f"{name}: {tname} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} needs unit stride on its last dim, got {t.stride()}")


def _check_shapes(name: str, expected: dict) -> None:
    """``expected`` maps an input's name to (tensor, shape it must have)."""
    if any(tuple(t.shape) != tuple(shape) for t, shape in expected.values()):
        got = " ".join(f"{n} {tuple(t.shape)}" for n, (t, _) in expected.items())
        raise ValueError(f"{name}: shapes {got} do not fit")


def _check_head_dims(name: str, d: int, dv: int, wide: bool = False) -> None:
    """K2 and K4 (``wide``) take d, dv ≤ 512, the other attention kernels ≤ 128."""
    max_d, max_dv = (_MAX_WIDE, _MAX_WIDE) if wide else (_MAX_D, _MAX_DV)
    if d > max_d or dv > max_dv:
        raise ValueError(f"{name}: head dims d={d}, dv={dv} exceed the kernel's {max_d}, {max_dv} "
                         "(wider heads are ROADMAP queue 1 item 13)")


def _device_lam(name: str, lam: torch.Tensor) -> torch.Tensor:
    """λ as the kernels read it: one fp32 element in device memory (no host sync)."""
    if not (lam.is_cuda and lam.dtype == torch.float32 and lam.numel() == 1):
        raise TypeError(f"{name}: lam must be a one-element float32 CUDA tensor")
    return lam.contiguous()


def _row_stats(name: str, shape, *stats: torch.Tensor):
    """The forward's fp32 row statistics, contiguous, each of ``shape``."""
    out = [t.float().contiguous() for t in stats]
    if any(tuple(t.shape) != tuple(shape) for t in out):
        raise ValueError(f"{name}: row statistics {[tuple(t.shape) for t in out]} are not {tuple(shape)}")
    return out


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dim has unit stride (the kernels read the other
    strides), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _kernel(source: str, symbol: str):
    return binding.kernel(source, symbol, _ARGTYPES[symbol])



def diff_attention_interleaved_fwd(q, k, v, lam):
    """softmax(q1·k1ᵀ)·V − λ·softmax(q2·k2ᵀ)·V on the interleaved layout.

    q, k ``(B, 2h, N|M, d)``; v ``(B, h, M, 2d)``; lam a 0-d fp32 tensor on the
    same device (read by the kernel from device memory: no host sync).
    Returns ``(o (B, h, N, 2d), lse1 (B, h, N), lse2 (B, h, N))``.
    """
    if q.device.type == "cpu":
        return diff_attention_interleaved_fwd_plain(q, k, v, lam)
    name = "diff_attention_interleaved_fwd"
    _check(name, {"q": q, "k": k, "v": v}, q.dtype)
    b, h2, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    h = h2 // 2
    if h2 % 2:
        raise ValueError(f"{name}: q has {h2} heads, not head pairs")
    _check_shapes(name, {"q": (q, q.shape), "k": (k, (b, h2, m, d)), "v": (v, (b, h, m, dv))})
    _check_head_dims(name, d, dv)
    lam = _device_lam(name, lam)
    o = torch.empty((b, h, n, dv), dtype=q.dtype, device=q.device)
    lse1 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lse2 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    rc = _kernel("diff_attention_fwd", "cenet_diff_attention_fwd")(
        int(q.dtype == torch.bfloat16), *binding.ptrs(q, k, v, lam, o, lse1, lse2), b, h, n, m, d, dv,
        *binding.strides(q), *binding.strides(k), *binding.strides(v), binding.stream(),
    )
    binding.raise_on(name, rc)
    LAUNCHES[name] += 1
    return o, lse1, lse2


def diff_attention_fwd(q1, k1, q2, k2, v, lam):
    """softmax(q1·k1ᵀ)·V − λ·softmax(q2·k2ᵀ)·V on split groups.

    q1, q2 ``(B, h, N, d)`` and k1, k2 ``(B, h, M, d)``, each with strides of its
    own (the ``0::2``/``1::2`` head views of the projections are read in place);
    v ``(B, h, M, dv)``; lam a 0-d fp32 tensor on the same device.
    Returns ``(o (B, h, N, dv), lse1 (B, h, N), lse2 (B, h, N))``.
    """
    if q1.device.type == "cpu":
        return diff_attention_fwd_plain(q1, k1, q2, k2, v, lam)
    name = "diff_attention_fwd"
    _check(name, {"q1": q1, "k1": k1, "q2": q2, "k2": k2, "v": v}, q1.dtype)
    b, h, n, d = q1.shape
    m, dv = k1.shape[2], v.shape[3]
    _check_shapes(name, {"q1": (q1, q1.shape), "k1": (k1, (b, h, m, d)), "q2": (q2, q1.shape),
                         "k2": (k2, (b, h, m, d)), "v": (v, (b, h, m, dv))})
    _check_head_dims(name, d, dv)
    lam = _device_lam(name, lam)
    o = torch.empty((b, h, n, dv), dtype=q1.dtype, device=q1.device)
    lse1 = torch.empty((b, h, n), dtype=torch.float32, device=q1.device)
    lse2 = torch.empty((b, h, n), dtype=torch.float32, device=q1.device)
    rc = _kernel("diff_attention_split_fwd", "cenet_diff_attention_split_fwd")(
        int(q1.dtype == torch.bfloat16), *binding.ptrs(q1, k1, q2, k2, v, lam, o, lse1, lse2), b, h, n, m, d, dv,
        *binding.strides(q1), *binding.strides(k1), *binding.strides(q2), *binding.strides(k2), *binding.strides(v),
        binding.stream(),
    )
    binding.raise_on(name, rc)
    LAUNCHES[name] += 1
    return o, lse1, lse2


def attention_fwd(q, k, v):
    """softmax(q·kᵀ)·v with q pre-scaled: q, k ``(B, H, N|M, d)``, v ``(B, H, M, dv)``,
    d, dv ≤ 512 (past 128 the wide designs of ``csrc/attention_wide.cuh``).
    Returns ``(o (B, H, N, dv), lse (B, H, N))``."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v)
    name = "attention_fwd"
    _check(name, {"q": q, "k": k, "v": v}, q.dtype)
    b, hh, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    _check_shapes(name, {"q": (q, q.shape), "k": (k, (b, hh, m, d)), "v": (v, (b, hh, m, dv))})
    _check_head_dims(name, d, dv, wide=True)
    o = torch.empty((b, hh, n, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hh, n), dtype=torch.float32, device=q.device)
    rc = _kernel("attention_fwd", "cenet_attention_fwd")(
        int(q.dtype == torch.bfloat16), *binding.ptrs(q, k, v, o, lse), b, hh, n, m, d, dv,
        *binding.strides(q), *binding.strides(k), *binding.strides(v), binding.stream(),
    )
    binding.raise_on(name, rc)
    LAUNCHES[name] += 1
    return o, lse


def diff_attention_interleaved_bwd(q, k, v, lam, lse1, lse2, do):
    """Gradients of :func:`diff_attention_interleaved_fwd`: ``do`` ``(B, h, N, 2d)``,
    ``lse1``/``lse2`` its fp32 row log-sum-exps. Returns ``(dq, dk, dv, dlam)``;
    dλ = −Σ δ₂ is one ``torch.sum`` over the kernel's per-row δ₂ (no host sync)."""
    if q.device.type == "cpu":
        return diff_attention_interleaved_bwd_plain(q, k, v, lam, lse1, lse2, do)
    name = "diff_attention_interleaved_bwd"
    do = _unit_last(do)
    _check(name, {"q": q, "k": k, "v": v, "do": do}, q.dtype)
    b, h2, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    h = h2 // 2
    if h2 % 2:
        raise ValueError(f"{name}: q has {h2} heads, not head pairs")
    _check_shapes(name, {"q": (q, q.shape), "k": (k, (b, h2, m, d)), "v": (v, (b, h, m, dv)),
                         "do": (do, (b, h, n, dv))})
    _check_head_dims(name, d, dv)
    lam = _device_lam(name, lam)
    lse1, lse2 = _row_stats(name, (b, h, n), lse1, lse2)
    delta1 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    delta2 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, h2, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h2, m, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, h, m, dv), dtype=q.dtype, device=q.device)
    rc = _kernel("diff_attention_bwd", "cenet_diff_attention_bwd")(
        int(q.dtype == torch.bfloat16), *binding.ptrs(q, k, v, do, lam, lse1, lse2, delta1, delta2, dq, dk, dvv),
        b, h, n, m, d, dv, *binding.strides(q), *binding.strides(k), *binding.strides(v), *binding.strides(do),
        binding.stream(),
    )
    binding.raise_on(name, rc)
    LAUNCHES[name] += 1
    return dq, dk, dvv, -delta2.sum()


def _diff_split_bwd(name, source, symbol, fused, q1, k1, q2, k2, v, lam, lse1, lse2, do):
    """Launch one of the split-group backwards. ``fused``: the one-launch kernel
    that adds dk₁, dk₂ and dv into zeroed fp32 buffers (cast here); otherwise
    the two-launch kernel writes them in q's dtype."""
    do = _unit_last(do)
    _check(name, {"q1": q1, "k1": k1, "q2": q2, "k2": k2, "v": v, "do": do}, q1.dtype)
    b, h, n, d = q1.shape
    m, dv = k1.shape[2], v.shape[3]
    _check_shapes(name, {"q1": (q1, q1.shape), "k1": (k1, (b, h, m, d)), "q2": (q2, q1.shape),
                         "k2": (k2, (b, h, m, d)), "v": (v, (b, h, m, dv)), "do": (do, (b, h, n, dv))})
    _check_head_dims(name, d, dv)
    lam = _device_lam(name, lam)
    lse1, lse2 = _row_stats(name, (b, h, n), lse1, lse2)
    dev, dtype = q1.device, q1.dtype
    delta1 = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    delta2 = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    dq1 = torch.empty((b, h, n, d), dtype=dtype, device=dev)
    dq2 = torch.empty((b, h, n, d), dtype=dtype, device=dev)
    make, acc = (torch.zeros, torch.float32) if fused else (torch.empty, dtype)
    dk1 = make((b, h, m, d), dtype=acc, device=dev)
    dk2 = make((b, h, m, d), dtype=acc, device=dev)
    dvv = make((b, h, m, dv), dtype=acc, device=dev)
    rc = _kernel(source, symbol)(
        int(dtype == torch.bfloat16),
        *binding.ptrs(q1, k1, q2, k2, v, do, lam, lse1, lse2, delta1, delta2, dq1, dk1, dq2, dk2, dvv),
        b, h, n, m, d, dv, *binding.strides(q1), *binding.strides(k1), *binding.strides(q2), *binding.strides(k2),
        *binding.strides(v),
        *binding.strides(do), binding.stream(),
    )
    binding.raise_on(name, rc)
    LAUNCHES[name] += 1
    return dq1, dk1.to(dtype), dq2, dk2.to(dtype), dvv.to(dtype), -delta2.sum()


def diff_attention_bwd(q1, k1, q2, k2, v, lam, lse1, lse2, do):
    """Gradients of :func:`diff_attention_fwd` in one launch (K6): ``do``
    ``(B, h, N, dv)``, ``lse1``/``lse2`` its fp32 row log-sum-exps. dk₁, dk₂ and
    dv are summed over query tiles with fp32 atomics, so repeat runs differ in
    their last bits; dq₁, dq₂ and δ₂ repeat exactly. Returns
    ``(dq1, dk1, dq2, dk2, dv, dlam)``; dλ = −Σ δ₂ is one ``torch.sum`` over
    the kernel's per-row δ₂ (no host sync)."""
    if q1.device.type == "cpu":
        return diff_attention_bwd_plain(q1, k1, q2, k2, v, lam, lse1, lse2, do)
    return _diff_split_bwd("diff_attention_bwd", "diff_attention_split_bwd", "cenet_diff_attention_split_bwd",
                           True, q1, k1, q2, k2, v, lam, lse1, lse2, do)


def diff_attention_bwd_split(q1, k1, q2, k2, v, lam, lse1, lse2, do):
    """:func:`diff_attention_bwd`'s function in two launches (K7): a dq kernel
    (with δ₁, δ₂), then a dk/dv kernel; no atomics, so repeat runs are
    bit-identical. Its twin is :func:`diff_attention_bwd_plain`, as for K6."""
    if q1.device.type == "cpu":
        return diff_attention_bwd_plain(q1, k1, q2, k2, v, lam, lse1, lse2, do)
    return _diff_split_bwd("diff_attention_bwd_split", "diff_attention_split_bwd_two_kernel",
                           "cenet_diff_attention_split_bwd_two_kernel", False, q1, k1, q2, k2, v, lam, lse1, lse2, do)


def _attention_bwd(name, source, symbol, fused, q, k, v, o, lse, do):
    """Launch one of the attention backwards. Δ = rowsum(dO∘o) is taken here in
    fp32, outside the kernel, as the JAX package takes it. ``fused``: the
    one-launch kernel that adds dq into a zeroed fp32 buffer (cast here)."""
    do = _unit_last(do)
    _check(name, {"q": q, "k": k, "v": v, "do": do}, q.dtype)
    b, hh, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    _check_shapes(name, {"q": (q, q.shape), "k": (k, (b, hh, m, d)), "v": (v, (b, hh, m, dv)),
                         "o": (o, (b, hh, n, dv)), "do": (do, (b, hh, n, dv))})
    _check_head_dims(name, d, dv, wide=not fused)
    (lse,) = _row_stats(name, (b, hh, n), lse)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = (torch.zeros((b, hh, n, d), dtype=torch.float32, device=q.device) if fused
          else torch.empty((b, hh, n, d), dtype=q.dtype, device=q.device))
    dk = torch.empty((b, hh, m, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, hh, m, dv), dtype=q.dtype, device=q.device)
    rc = _kernel(source, symbol)(
        int(q.dtype == torch.bfloat16), *binding.ptrs(q, k, v, do, lse, delta, dq, dk, dvv), b, hh, n, m, d, dv,
        *binding.strides(q), *binding.strides(k), *binding.strides(v), *binding.strides(do), binding.stream(),
    )
    binding.raise_on(name, rc)
    LAUNCHES[name] += 1
    return dq.to(q.dtype), dk, dvv


def attention_bwd(q, k, v, o, lse, do):
    """Gradients of :func:`attention_fwd` (K4, a dq and a dk/dv kernel): ``o`` its
    output, ``lse`` its fp32 row log-sum-exp, ``do`` the gradient of ``o``.
    Takes d, dv ≤ 512, as :func:`attention_fwd` does. Returns ``(dq, dk, dv)``."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do)
    return _attention_bwd("attention_bwd", "attention_bwd", "cenet_attention_bwd", False, q, k, v, o, lse, do)


def attention_bwd_fused(q, k, v, o, lse, do):
    """:func:`attention_bwd`'s function in one launch (K8): dq is summed over key
    tiles with fp32 atomics, so repeat runs differ in its last bits. Its twin is
    :func:`attention_bwd_plain`, as for K4. Takes d, dv ≤ 128 (no router calls it)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do)
    return _attention_bwd("attention_bwd_fused", "attention_bwd_fused", "cenet_attention_bwd_fused", True,
                          q, k, v, o, lse, do)


# ---------------------------------------------------------------------------
# autograd Functions (the custom_vjp pairs of the JAX package)
# ---------------------------------------------------------------------------


class DiffAttentionInterleavedFn(torch.autograd.Function):
    """Diff attention whose forward is :func:`diff_attention_interleaved_fwd` (K1)
    and whose backward is :func:`diff_attention_interleaved_bwd` (K3), with a
    real gradient for λ (``pallas_diff_attention_interleaved``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, lam):
        o, lse1, lse2 = diff_attention_interleaved_fwd(q, k, v, lam)
        ctx.save_for_backward(q, k, v, lam, lse1, lse2)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lam, lse1, lse2 = ctx.saved_tensors
        dq, dk, dv, dlam = diff_attention_interleaved_bwd(q, k, v, lam, lse1, lse2, do)
        return dq, dk, dv, dlam.reshape(lam.shape)


class DiffAttentionFn(torch.autograd.Function):
    """Split-group diff attention whose forward is :func:`diff_attention_fwd` (K5)
    and whose backward is :func:`diff_attention_bwd` (K6), with a real gradient
    for λ (``pallas_diff_attention``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q1, k1, q2, k2, v, lam):
        o, lse1, lse2 = diff_attention_fwd(q1, k1, q2, k2, v, lam)
        ctx.save_for_backward(q1, k1, q2, k2, v, lam, lse1, lse2)
        return o

    @staticmethod
    def backward(ctx, do):
        q1, k1, q2, k2, v, lam, lse1, lse2 = ctx.saved_tensors
        *grads, dlam = diff_attention_bwd(q1, k1, q2, k2, v, lam, lse1, lse2, do)
        return (*grads, dlam.reshape(lam.shape))


class AttentionFn(torch.autograd.Function):
    """softmax(q·kᵀ)·v whose forward is :func:`attention_fwd` (K2) and whose
    backward is :func:`attention_bwd` (K4) (``pallas_attention``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return attention_bwd(q, k, v, o, lse, do)
