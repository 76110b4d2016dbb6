"""Attention routing: plain math for small maps and CPU tensors, kernels otherwise.

Mirrors ``cenet_tpu/ops/flash_attention.py:148-269`` with the same size rule:
a site reaches a kernel only when its full fp32 map is larger than
``_SMALL_LIMIT`` (32 MB), so the same sites reach the kernels in both packages.
The limit is module-level so that tests and ``chip_smoke.py`` can change it.
CPU tensors always take the plain path. CUDA tensors above the limit always
take the kernel: a kernel that fails raises, it is not hidden behind a fallback.
When autograd records (grad mode on and an input requires grad), the kernel is
reached through its ``torch.autograd.Function``, whose backward is the backward
kernel; otherwise (``inference_mode``, ``no_grad``) the forward kernel is called
alone and nothing is saved. :func:`parse_impl` splits an ``attn_impl`` string
as the JAX package does; the ring and ``@axis`` variants of the JAX routers are
later work (``nn.attention.get_attention_core`` raises on them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cenet_tpu_torch.nn.functional import softmax_fp32
from cenet_tpu_torch.ops import attention_kernels as K

_SMALL_LIMIT = 32 * 1024 * 1024


def parse_impl(impl: str) -> Tuple[str, Optional[str]]:
    """Split an attention-impl string into (core, tensor-parallel axis), as
    ``cenet_tpu/ops/flash_attention.py::parse_impl`` does: ``'pallas@model'`` →
    ``('pallas', 'model')``, ``'pallas'`` → ``('pallas', None)``."""
    if "@" in impl:
        core, axis = impl.split("@", 1)
        return core, axis
    return impl, None


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ)·v in the input dtype with an fp32 softmax (q pre-scaled)."""
    return torch.matmul(softmax_fp32(torch.matmul(q, k.transpose(-1, -2))), v)


def _use_kernel(q: torch.Tensor, map_elems: int) -> bool:
    return q.device.type != "cpu" and map_elems * 4 > _SMALL_LIMIT


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def diff_attention_core(q1, k1, q2, k2, v, lam) -> torch.Tensor:
    """softmax(q1·k1ᵀ)·V − λ·softmax(q2·k2ᵀ)·V with shared V on split groups
    (q1, q2 ``(B, h, N, d)``, k1, k2 ``(B, h, M, d)``, fp32 λ): the split-group
    kernel above the size limit on the card (``pallas_diff_attention``'s route),
    else plain math in the reference's A₁V − λA₂V order of operations."""
    b, h, n, _ = q1.shape
    if _use_kernel(q1, b * h * n * k1.shape[2]):
        if _records_grad(q1, k1, q2, k2, v, lam):
            return K.DiffAttentionFn.apply(q1, k1, q2, k2, v, lam)
        return K.diff_attention_fwd(q1, k1, q2, k2, v, lam)[0]
    return diff_attention_plain(q1, k1, q2, k2, v, lam)


def diff_attention_plain(q1, k1, q2, k2, v, lam) -> torch.Tensor:
    """Plain math for :func:`diff_attention_core`'s function, in the reference's
    A₁V − λA₂V order of operations; never a kernel."""
    out1 = plain_attention(q1, k1, v)
    out2 = plain_attention(q2, k2, v)
    return out1 - lam.to(out1.dtype) * out2


def diff_attention_split(q, k, v, lam) -> torch.Tensor:
    """Diff attention on the interleaved layout through the split groups: the
    even and odd head views of q and k go to :func:`diff_attention_core` (the
    JAX router's decomposition, ``flash_attention.py:245``)."""
    return diff_attention_core(q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2], v, lam)


def diff_attention_interleaved(q, k, v, lam) -> torch.Tensor:
    """Diff attention on the projections' interleaved layout: q/k ``(B, 2h, N, d)``
    with group-1 heads at even rows, shared v ``(B, h, M, 2d)``, fp32 λ."""
    b, h2, n, _ = q.shape
    if _use_kernel(q, (b * h2 // 2) * n * k.shape[2]):
        if _records_grad(q, k, v, lam):
            return K.DiffAttentionInterleavedFn.apply(q, k, v, lam)
        return K.diff_attention_interleaved_fwd(q, k, v, lam)[0]
    return diff_attention_split(q, k, v, lam)


def flash_attention_core(q, k, v) -> torch.Tensor:
    """softmax(q·kᵀ)·v (q pre-scaled): the kernel above the size limit on the card."""
    b, h, n, _ = q.shape
    if _use_kernel(q, b * h * n * k.shape[2]):
        if _records_grad(q, k, v):
            return K.AttentionFn.apply(q, k, v)
        return K.attention_fwd(q, k, v)[0]
    return plain_attention(q, k, v)
