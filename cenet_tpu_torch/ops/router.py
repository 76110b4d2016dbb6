"""Attention routing: plain math for small maps and CPU tensors, kernels otherwise.

Mirrors ``cenet_tpu/ops/flash_attention.py:148-269`` with the same size rule:
a site reaches a kernel only when its full fp32 map is larger than
``_SMALL_LIMIT`` (32 MB), so the same sites reach the kernels in both packages.
The limit is module-level so that tests and ``chip_smoke.py`` can change it.
Tensors off the card always take the plain path: CPU tensors, and ``meta``
tensors, on which ``core/stats.py::model_cost`` counts a model's work. CUDA
tensors above the limit always take the kernel: a kernel that fails raises, it
is not hidden behind a fallback.
When autograd records (grad mode on and an input requires grad), the kernel is
reached through its ``torch.autograd.Function``, whose backward is the backward
kernel; otherwise (``inference_mode``, ``no_grad``) the forward kernel is called
alone and nothing is saved. :func:`parse_impl` splits an ``attn_impl`` string
as the JAX package does.

Under a mesh (``core/mesh.py``) the rule reads the shape that the JAX package
sees at the same site. Under plain data parallelism GSPMD runs the bare core
on the global batch, so the map counts the local batch times ``data``
(``core.mesh.global_batch``). Under ``'@model'`` the JAX core runs inside
``shard_map`` on the local batch and heads; the head-sharded modules of
``nn/attention.py`` call the cores with ``head_local=True`` and the map counts
what they hand over. A site whose heads do not divide the model axis is
replicated and counts the global batch, as JAX's fall-through to the bare
core does. :func:`shard_heads` is ``flash_attention.py::shard_heads``: a core
on full heads that runs on the rank's heads and gathers them.

``impl='ring'`` (or ``'ring@seq'``) takes the diff-attention routers to the
JAX package's ring branch (``flash_attention.py:158-166,215-222``): the two
softmax groups of the split views each ride the ring of
``ops/ring_attention.py`` (K2 and K4 on every hop on the card), and
out1 − λ·out2 is formed after, with λ in the activation dtype. On the card
a site whose groups do not ride the ring (no seq group, N ≠ M, N not a
multiple of ``seq``) keeps this router's own route and its kernels (K1/K3,
or K5 on split views); off the card it takes the branch, whose fallback is
JAX's (query blocks above the limit).
:func:`chunked_attention_core` is the JAX package's query-block scan
(``flash_attention.py:119-145``): the core that ``'chunked'`` names
(``nn/attention.py::get_attention_core``), and the ring core's fallback for
large maps. :func:`diff_attention_chunked` is the diff-attention routers'
``'chunked'`` branch (``flash_attention.py:190-195``): plain math at most
``_SMALL_LIMIT``, a scan of each group above it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from cenet_tpu_torch.core import mesh as M
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


def _rows(b: int, head_local: bool) -> int:
    """The batch the JAX package's core sees for a rank's ``b`` rows."""
    return b if head_local else M.global_batch(b)


def _use_kernel(q: torch.Tensor, map_elems: int) -> bool:
    return q.device.type == "cuda" and map_elems * 4 > _SMALL_LIMIT


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def chunked_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_chunk: int = 512) -> torch.Tensor:
    """softmax(q·kᵀ)·v over blocks of ``q_chunk`` query rows (q pre-scaled),
    ``cenet_tpu/ops/flash_attention.py::chunked_attention_core``: the tail
    padded with zero rows, each block's full fp32 softmax rows formed under
    ``torch.utils.checkpoint`` (its map recomputed in the backward, not
    saved), so no more than a block's (B, H, q_chunk, M) map exists at once.
    On ``meta`` tensors, where ``core/stats.py::model_cost`` counts a model's
    work, plain math: the same function without the padded rows."""
    if q.device.type == "meta":
        return plain_attention(q, k, v)
    n = q.shape[2]
    c = min(q_chunk, n)
    pad = (-n) % c
    if pad:
        q = torch.cat([q, q.new_zeros(q.shape[:2] + (pad, q.shape[3]))], dim=2)
    blocks = [torch.utils.checkpoint.checkpoint(plain_attention, blk, k, v, use_reentrant=False)
              for blk in q.split(c, dim=2)]
    return torch.cat(blocks, dim=2)[:, :, :n]


def _ring_core(impl: str, q: torch.Tensor, k: torch.Tensor):
    """The ring core when ``impl`` is ``'ring'``/``'ring@axis'`` and the site takes
    the ring branch (always off the card; on the card only where q and k ride
    the ring), else None."""
    core, axis = parse_impl(impl)
    if core != "ring":
        return None
    from cenet_tpu_torch.ops import ring_attention

    ring = ring_attention.make_ring_core(axis or "seq")
    return ring if q.device.type != "cuda" or ring_attention.ring_mesh(q, k) is not None else None


def _ring_diff(core, q1, k1, q2, k2, v, lam, head_local: bool) -> torch.Tensor:
    """The JAX routers' ring branch: each softmax group rides the ring, then out1 − λ·out2."""
    out1 = core(q1, k1, v, head_local=head_local)
    out2 = core(q2, k2, v, head_local=head_local)
    return out1 - lam.to(out1.dtype) * out2


def diff_attention_core(q1, k1, q2, k2, v, lam, head_local: bool = False, impl: str = "pallas") -> torch.Tensor:
    """softmax(q1·k1ᵀ)·V − λ·softmax(q2·k2ᵀ)·V with shared V on split groups
    (q1, q2 ``(B, h, N, d)``, k1, k2 ``(B, h, M, d)``, fp32 λ): the split-group
    kernel above the size limit on the card (``pallas_diff_attention``'s route),
    else plain math in the reference's A₁V − λA₂V order of operations; under
    ``impl='ring'`` each group on the ring, where the site takes the ring branch."""
    ring = _ring_core(impl, q1, k1)
    if ring is not None:
        return _ring_diff(ring, q1, k1, q2, k2, v, lam, head_local)
    b, h, n, _ = q1.shape
    if _use_kernel(q1, _rows(b, head_local) * h * n * k1.shape[2]):
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


def diff_attention_chunked(q1, k1, q2, k2, v, lam, head_local: bool = False) -> torch.Tensor:
    """:func:`diff_attention_core`'s function under ``'chunked'``, as the JAX
    routers take it (``flash_attention.py:190-195``): plain math while the
    full fp32 map is at most ``_SMALL_LIMIT``, else each group through
    :func:`chunked_attention_core`; never a kernel."""
    b, h, n, _ = q1.shape
    if _rows(b, head_local) * h * n * k1.shape[2] * 4 <= _SMALL_LIMIT:
        return diff_attention_plain(q1, k1, q2, k2, v, lam)
    out1 = chunked_attention_core(q1, k1, v)
    out2 = chunked_attention_core(q2, k2, v)
    return out1 - lam.to(out1.dtype) * out2


def diff_attention_split(q, k, v, lam, head_local: bool = False, impl: str = "pallas") -> torch.Tensor:
    """Diff attention on the interleaved layout through the split groups: the
    even and odd head views of q and k go to :func:`diff_attention_core` (the
    JAX router's decomposition, ``flash_attention.py:245``)."""
    return diff_attention_core(q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2], v, lam, head_local=head_local,
                               impl=impl)


def diff_attention_interleaved(q, k, v, lam, head_local: bool = False, impl: str = "pallas") -> torch.Tensor:
    """Diff attention on the projections' interleaved layout: q/k ``(B, 2h, N, d)``
    with group-1 heads at even rows, shared v ``(B, h, M, 2d)``, fp32 λ. Under
    ``impl='ring'`` the split groups, each on the ring, where the site takes
    the ring branch."""
    if _ring_core(impl, q, k) is not None:
        return diff_attention_split(q, k, v, lam, head_local=head_local, impl=impl)
    b, h2, n, _ = q.shape
    if _use_kernel(q, (_rows(b, head_local) * h2 // 2) * n * k.shape[2]):
        if _records_grad(q, k, v, lam):
            return K.DiffAttentionInterleavedFn.apply(q, k, v, lam)
        return K.diff_attention_interleaved_fwd(q, k, v, lam)[0]
    return diff_attention_split(q, k, v, lam, head_local=head_local)


def flash_attention_core(q, k, v, head_local: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ)·v (q pre-scaled): the kernel above the size limit on the card."""
    b, h, n, _ = q.shape
    if _use_kernel(q, _rows(b, head_local) * h * n * k.shape[2]):
        if _records_grad(q, k, v):
            return K.AttentionFn.apply(q, k, v)
        return K.attention_fwd(q, k, v)[0]
    return plain_attention(q, k, v)


class _GatherHeads(torch.autograd.Function):
    """The model group's head pieces concatenated on dim 1 (every rank gets the
    whole); the backward takes the rank's piece of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.h = mesh, x.shape[1]
        return M.gather_cat(x, mesh.model_group, mesh.model, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.mesh.m * ctx.h, ctx.h), None


def shard_heads(core, axis: Optional[str]):
    """``core(q, k, v)`` on full, replicated heads, run on the rank's heads when
    the registered mesh's ``axis`` divides them, the pieces gathered after
    (``cenet_tpu/ops/flash_attention.py::shard_heads``). The bare core without
    an axis, without a mesh (or a process group), or when the heads do not divide."""
    if axis is None:
        return core

    def wrapped(q, k, v):
        mesh = M.get_attention_mesh()
        width = mesh.model if mesh is not None and axis == "model" else 1  # the mesh has no other head axis
        if mesh is None or mesh.model_group is None or width <= 1 or q.shape[1] % width:
            return core(q, k, v)
        h = q.shape[1] // width
        mine = slice(mesh.m * h, (mesh.m + 1) * h)
        # each rank's input gradient covers its heads only: summed over the group
        q, k, v = (M.copy_to_model(t, mesh.model_group)[:, mine] for t in (q, k, v))
        local = core(q, k, v, head_local=True) if core is flash_attention_core else core(q, k, v)
        return _GatherHeads.apply(local, mesh)

    return wrapped
