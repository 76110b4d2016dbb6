"""Rotary position embedding: plain PyTorch, and the half-split CUDA kernel (K10).

Mirrors ``cenet_tpu/ops/rotary.py``. :func:`make_rotary_tables` and
:func:`apply_rotary_emb` (both conventions, rotary dim rd ≤ D) are the plain
functions ``MultiheadDiffAttn(use_rotary=True)`` calls, computed in x's dtype
as the XLA ones are. :func:`apply_rotary_emb_kernel` is the counterpart of
``apply_rotary_emb_pallas`` (forward only, half-split, rd = D), source
``csrc/rotary.cu``, with its twin :func:`apply_rotary_emb_kernel_plain`.

``interleaved=True`` (GPT-J): pairs (x₀, x₁), (x₂, x₃) … are rotated.
``interleaved=False`` (GPT-NeoX): the two halves of the first rd dims are.
The interleaved function is the half-split one on the de-interleaved dims
(evens, then odds), re-interleaved after: :func:`deinterleave` and
:func:`reinterleave` give that composition the same products and sums.
"""

from __future__ import annotations

import torch

from cenet_tpu_torch.ops import binding

_ARGTYPES = [binding.I] * 2 + [binding.P] * 4 + [binding.I] * 7 + [binding.P]


def make_rotary_tables(seq_len: int, rotary_dim: int, base: float = 10000.0, device=None):
    """cos/sin tables of shape (seq_len, rotary_dim // 2), fp32."""
    inv_freq = 1.0 / (base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim))
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32, device=device), inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleaved: bool = True) -> torch.Tensor:
    """x: (B, H, N, D); cos/sin: (N, rd/2) with rd ≤ D. Rotates the first rd dims,
    in x's dtype."""
    rd = 2 * cos.shape[-1]
    xr, xp = x[..., :rd], x[..., rd:]
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    if interleaved:
        x0, x1 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(xr.shape)
    else:
        half = rd // 2
        x0, x1 = xr[..., :half], xr[..., half:]
        out = torch.cat([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The last dim's even entries, then its odd ones."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def reinterleave(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`deinterleave`."""
    half = x.shape[-1] // 2
    return torch.stack([x[..., :half], x[..., half:]], dim=-1).reshape(x.shape)


def apply_rotary_emb_kernel_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The function of K10 (``_rotary_kernel``): half-split rotary with rd = D,
    the tables rounded to x's dtype, every product and sum in x's dtype."""
    return apply_rotary_emb(x, cos, sin, interleaved=False)


def apply_rotary_emb_kernel(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The counterpart of ``apply_rotary_emb_pallas``: half-split rotary of x
    ``(B, H, N, D)`` (any batch, head and row strides, unit stride on D) with
    cos/sin ``(N, D/2)``, fp32 (rounded to x's dtype in the kernel) or already in
    x's dtype. Returns a contiguous ``(B, H, N, D)`` in x's dtype."""
    if x.device.type == "cpu":
        return apply_rotary_emb_kernel_plain(x, cos, sin)
    name = "rotary"
    binding.check_cuda_dtype(name, {"x": x}, x.dtype)
    b, h, n, d = x.shape
    if d % 2 or tuple(cos.shape) != (n, d // 2) or tuple(sin.shape) != (n, d // 2):
        raise ValueError(f"{name}: x {tuple(x.shape)} with tables {tuple(cos.shape)}, {tuple(sin.shape)}")
    x = x if x.stride(-1) == 1 else x.contiguous()
    # fp32 tables go to the kernel as they are; others are cast to x's dtype
    # first, as the twin casts them (a no-op for tables already in x's dtype)
    c, s = (t.to(x.device, t.dtype if t.dtype == torch.float32 else x.dtype).contiguous() for t in (cos, sin))
    if c.dtype != s.dtype:
        c, s = c.to(x.dtype), s.to(x.dtype)
    out = torch.empty((b, h, n, d), dtype=x.dtype, device=x.device)
    if max(binding.last_offset(x), out.numel()) >= 2**31:
        raise ValueError(f"{name}: x {tuple(x.shape)} strides {x.stride()} pass 32-bit element offsets")
    rc = binding.kernel("rotary", "cenet_rotary", _ARGTYPES)(
        binding.is_bf16(x), int(c.dtype == torch.bfloat16), *binding.ptrs(x, c, s, out), b, h, n, d,
        *binding.strides(x), binding.stream())
    binding.raise_on(name, rc)
    binding.LAUNCHES[name] += 1
    return out

