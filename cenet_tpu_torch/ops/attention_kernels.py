"""Attention kernels for Hopper, with their plain PyTorch twins and autograd Functions.

Mirrors the kernels of ``cenet_tpu/ops/pallas_attention.py`` on the main path:

* :func:`diff_attention_interleaved_fwd` replaces ``_diff_fwd_pair_impl``
  (``pallas_diff_attention_interleaved``), source ``csrc/diff_attention_fwd.cu``;
* :func:`attention_fwd` replaces ``_pallas_attention_fwd_impl``
  (``pallas_attention``), source ``csrc/attention_fwd.cu``;
* :func:`diff_attention_interleaved_bwd` replaces ``_diff_bwd_pair_impl``, the
  backward of ``pallas_diff_attention_interleaved``, source
  ``csrc/diff_attention_bwd.cu``;
* :func:`attention_bwd` replaces ``_pallas_attention_bwd_impl``, the backward of
  ``pallas_attention``, source ``csrc/attention_bwd.cu``.

:class:`DiffAttentionInterleavedFn` and :class:`AttentionFn` pair each forward
kernel with its backward, as the ``custom_vjp``s of the JAX package do.

Each wrapper takes its plain twin only for tensors on the CPU. For CUDA tensors
it launches the kernel (built at first use by :mod:`cenet_tpu_torch.ops.build`)
or raises; it never falls back. ``LAUNCHES`` counts kernel launches by name.
The public functions keep the JAX layout: q/k ``(B, 2h, N, d)`` with even heads
group 1, v ``(B, h, M, 2d)`` for the diff kernel; ``(B, H, N|M, d)`` for plain
attention. q is pre-scaled. The forwards return ``o`` in q's dtype and the fp32
row log-sum-exp ``(B, h, N)`` (two of them for the diff kernel); the backwards
take the upstream gradient ``do`` with the shape of ``o`` (any batch, head and
row strides, passed to the kernel like q/k/v's) and return the gradients in
the inputs' dtypes, contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cenet_tpu_torch.ops import build

LAUNCHES = {"diff_attention_interleaved_fwd": 0, "attention_fwd": 0,
            "diff_attention_interleaved_bwd": 0, "attention_bwd": 0}

_MAX_D, _MAX_DV = 128, 128  # csrc/attention_fwd_common.cuh: MAX_D, MAX_DV
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures (csrc/*.cu): is_bf16, pointers, B, H, N, M, D, DV, 3 strides per
# strided input, stream
_ARGTYPES = {
    "cenet_diff_attention_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_L] * 9 + [_P],
    "cenet_attention_fwd": [_I] + [_P] * 5 + [_I] * 6 + [_L] * 9 + [_P],
    "cenet_diff_attention_bwd": [_I] + [_P] * 12 + [_I] * 6 + [_L] * 12 + [_P],
    "cenet_attention_bwd": [_I] + [_P] * 9 + [_I] * 6 + [_L] * 12 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain twins (CPU path, and the yardstick the kernels are held against)
# ---------------------------------------------------------------------------


def _row_softmax_parts(q: torch.Tensor, k: torch.Tensor):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    d = e.sum(dim=-1, keepdim=True)
    return e, d, (m + torch.log(d))[..., 0]


def diff_attention_interleaved_fwd_plain(q, k, v, lam) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function of ``_diff_fwd_pair_kernel`` in plain PyTorch: fp32 logits
    and softmax, w = e1/d1 − λ·e2/d2 cast to v's dtype, fp32 product."""
    e1, d1, lse1 = _row_softmax_parts(q[:, 0::2], k[:, 0::2])
    e2, d2, lse2 = _row_softmax_parts(q[:, 1::2], k[:, 1::2])
    w = e1 / d1 - lam.float() * (e2 / d2)
    o = torch.matmul(w.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse1, lse2


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


def diff_attention_interleaved_bwd_plain(q, k, v, lam, lse1, lse2, do):
    """The function of ``_diff_bwd_pair_kernel`` in plain PyTorch. With G = dO·Vᵀ,
    per group δ_g = rowsum(P_g∘G), ds_g = P_g(G − δ_g), dq_g = c_g·round(ds_g)·k_g,
    dk_g = c_g·round(ds_g)ᵀ·q_g (c₁ = 1, c₂ = −λ); dv = round(P₁ − λP₂)ᵀ·dO;
    dλ = −Σ δ₂. Returns ``(dq, dk, dv, dlam)`` in the dtypes of q, k, v, lam."""
    lam_f = lam.float()
    g = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dq, dk, p, delta = [], [], [], []
    for grp, lse, c in ((0, lse1, 1.0), (1, lse2, -lam_f)):
        qg, kg = q[:, grp::2], k[:, grp::2]
        pg = _probs(qg, kg, lse)
        dg = (pg * g).sum(-1, keepdim=True)
        ds = pg * (g - dg)
        dq.append((c * _mm(ds, kg, k.dtype)).to(q.dtype))
        dk.append(c * _mm(ds.transpose(-1, -2), qg, q.dtype))
        p.append(pg)
        delta.append(dg)
    b, h2, n, d = q.shape
    dq = torch.stack(dq, dim=2).reshape(b, h2, n, d)
    dk = torch.stack(dk, dim=2).reshape(b, h2, k.shape[2], d).to(k.dtype)
    dv = _mm((p[0] - lam_f * p[1]).transpose(-1, -2), do, do.dtype).to(v.dtype)
    return dq, dk, dv, (-delta[1].sum()).to(lam.dtype)


def attention_bwd_plain(q, k, v, o, lse, do):
    """The function of ``_attn_dq_kernel`` and ``_attn_dkv_kernel`` in plain
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
    for tname, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {tname} is on {t.device}, the other inputs on CUDA")
        if t.dtype != dtype or dtype not in _DTYPES:
            raise TypeError(f"{name}: {tname} is {t.dtype}; the kernel takes float32 or bfloat16, all alike")
        if t.ndim != 4:
            raise ValueError(f"{name}: {tname} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} needs unit stride on its last dim, got {t.stride()}")


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dim has unit stride (the kernels read the other
    strides), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _kernel(source: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built first if needed."""
    fn = getattr(build.load(source), symbol)
    fn.argtypes, fn.restype = _ARGTYPES[symbol], _I
    return fn


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


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
    if h2 % 2 or k.shape != (b, h2, m, d) or v.shape != (b, h, m, dv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} do not fit")
    if d > _MAX_D or dv > _MAX_DV:
        raise ValueError(f"{name}: head dims d={d}, dv={dv} exceed the kernel's {_MAX_D}, {_MAX_DV}")
    if not (lam.is_cuda and lam.dtype == torch.float32 and lam.numel() == 1):
        raise TypeError(f"{name}: lam must be a one-element float32 CUDA tensor")
    lam = lam.contiguous()
    o = torch.empty((b, h, n, dv), dtype=q.dtype, device=q.device)
    lse1 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lse2 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    rc = _kernel("diff_attention_fwd", "cenet_diff_attention_fwd")(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), lam.data_ptr(),
        o.data_ptr(), lse1.data_ptr(), lse2.data_ptr(), b, h, n, m, d, dv,
        *_strides(q), *_strides(k), *_strides(v), _stream(),
    )
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return o, lse1, lse2


def attention_fwd(q, k, v):
    """softmax(q·kᵀ)·v with q pre-scaled: q, k ``(B, H, N|M, d)``, v ``(B, H, M, dv)``.
    Returns ``(o (B, H, N, dv), lse (B, H, N))``."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v)
    name = "attention_fwd"
    _check(name, {"q": q, "k": k, "v": v}, q.dtype)
    b, hh, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    if k.shape != (b, hh, m, d) or v.shape != (b, hh, m, dv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} do not fit")
    if d > _MAX_D or dv > _MAX_DV:
        raise ValueError(f"{name}: head dims d={d}, dv={dv} exceed the kernel's {_MAX_D}, {_MAX_DV}")
    o = torch.empty((b, hh, n, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hh, n), dtype=torch.float32, device=q.device)
    rc = _kernel("attention_fwd", "cenet_attention_fwd")(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, hh, n, m, d, dv,
        *_strides(q), *_strides(k), *_strides(v), _stream(),
    )
    _raise_on(name, rc)
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
    if h2 % 2 or k.shape != (b, h2, m, d) or v.shape != (b, h, m, dv) or do.shape != (b, h, n, dv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"do {tuple(do.shape)} do not fit")
    if d > _MAX_D or dv > _MAX_DV:
        raise ValueError(f"{name}: head dims d={d}, dv={dv} exceed the kernel's {_MAX_D}, {_MAX_DV}")
    if not (lam.is_cuda and lam.dtype == torch.float32 and lam.numel() == 1):
        raise TypeError(f"{name}: lam must be a one-element float32 CUDA tensor")
    lse1, lse2 = lse1.float().contiguous(), lse2.float().contiguous()
    if lse1.shape != (b, h, n) or lse2.shape != (b, h, n):
        raise ValueError(f"{name}: lse shapes {tuple(lse1.shape)}, {tuple(lse2.shape)} are not {(b, h, n)}")
    lam = lam.contiguous()
    delta1 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    delta2 = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, h2, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h2, m, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, h, m, dv), dtype=q.dtype, device=q.device)
    rc = _kernel("diff_attention_bwd", "cenet_diff_attention_bwd")(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lam.data_ptr(),
        lse1.data_ptr(), lse2.data_ptr(), delta1.data_ptr(), delta2.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, h, n, m, d, dv,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), _stream(),
    )
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return dq, dk, dvv, -delta2.sum()


def attention_bwd(q, k, v, o, lse, do):
    """Gradients of :func:`attention_fwd`: ``o`` its output, ``lse`` its fp32 row
    log-sum-exp, ``do`` the gradient of ``o``. Δ = rowsum(dO∘o) is taken here in
    fp32, outside the kernel, as the JAX package takes it. Returns ``(dq, dk, dv)``."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do)
    name = "attention_bwd"
    do = _unit_last(do)
    _check(name, {"q": q, "k": k, "v": v, "do": do}, q.dtype)
    b, hh, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    if k.shape != (b, hh, m, d) or v.shape != (b, hh, m, dv) or do.shape != (b, hh, n, dv) or o.shape != do.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"o {tuple(o.shape)} do {tuple(do.shape)} do not fit")
    if d > _MAX_D or dv > _MAX_DV:
        raise ValueError(f"{name}: head dims d={d}, dv={dv} exceed the kernel's {_MAX_D}, {_MAX_DV}")
    lse = lse.float().contiguous()
    if lse.shape != (b, hh, n):
        raise ValueError(f"{name}: lse shape {tuple(lse.shape)} is not {(b, hh, n)}")
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = torch.empty((b, hh, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hh, m, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, hh, m, dv), dtype=q.dtype, device=q.device)
    rc = _kernel("attention_bwd", "cenet_attention_bwd")(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, hh, n, m, d, dv,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), _stream(),
    )
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return dq, dk, dvv


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
