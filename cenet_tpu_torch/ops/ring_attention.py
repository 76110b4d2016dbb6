"""Ring attention over the mesh's ``seq`` axis: counterpart of ``cenet_tpu/ops/ring_attention.py``.

Exact softmax(q·kᵀ)·v with the tokens split over the ranks of a seq group
(``core/mesh.py``). Every rank holds q, k and v whole (everything around a
ring site is replicated over ``seq``); the core takes the rank's block of
each (``mesh.split_tokens``), runs :class:`RingAttentionFn` on the blocks
and gathers the blocks of the output (``mesh.gather_tokens``), so each rank
forms only its block's N/p × N logits a hop instead of the N × N map.

:class:`RingAttentionFn` runs p hops. Forward: at hop j the rank's q meets
the k/v block of the rank j places before it, through K2
(``attention_kernels.attention_fwd``: the CUDA kernel for CUDA tensors, its
plain twin for CPU tensors), which returns the hop's output o_j and row
log-sum-exp lse_j; meanwhile k/v pass one rank on (``mesh.ring_pass``). The
hops merge in fp32 as they come, LSE ← logaddexp(LSE, lse_j) and
O ← O·exp(LSE_old − LSE) + o_j·exp(lse_j − LSE), and O is rounded once to
the input dtype. Backward: p hops of K4 (``attention_bwd``) with the final O
and the merged LSE, so that each hop's P = exp(q·k_jᵀ − LSE) and its
Δ = rowsum(dO∘O) are the global ones: dq sums the hops' dq_j in fp32 on the
rank, and fp32 dk/dv accumulators ride the ring with k/v, each rank adding
its share, until one last hop hands each to its owner. The JAX body is an
einsum scan with online softmax state; on the card each hop is exactly K2's
function (forward) or K4's (backward), so the port runs those kernels. A
kernel that fails raises: no fallback hides it.

:func:`make_ring_core` keeps the JAX core's conditions (:func:`ring_mesh`):
without a registered mesh, with a seq axis of 1, for cross-attention (N ≠ M)
or N not a multiple of ``seq`` it is the core on the whole tokens, with the
JAX core's size rule on the full fp32 map of the batch and heads JAX sees:
at most ``router._SMALL_LIMIT``, plain math; above it, K2 (and K4 in the
backward) for CUDA tensors, as the router's kernels take the same function,
and query blocks (``router.chunked_attention_core``, the JAX fallback) for
CPU tensors. JAX's fallback has no Pallas kernel; the port's keeps its
kernel on the card. On ``meta`` tensors (``core/stats.py``'s count) it is
plain math and calls no collective. Only the ``seq`` axis carries tokens in
the port: the data and model ranks hold other rows and heads, so
``'ring@data'`` and ``'ring@model'`` raise.
"""

from __future__ import annotations

from typing import Callable

import torch

from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import router


def _merge(acc, lse, o_j, lse_j):
    """Fold one hop's (o_j, lse_j) into the fp32 running (O, LSE)."""
    if acc is None:
        return o_j.float(), lse_j
    new = torch.logaddexp(lse, lse_j)
    return acc * torch.exp(lse - new)[..., None] + o_j.float() * torch.exp(lse_j - new)[..., None], new


def ring_forward(q, k, v, mesh):
    """(O in q's dtype, fp32 LSE) of the rank's query block against every k/v block of its seq group."""
    acc = lse = None
    kv = (k, v)
    for hop in range(mesh.seq):
        pending = M.ring_pass(kv, mesh) if hop < mesh.seq - 1 else None
        acc, lse = _merge(acc, lse, *K.attention_fwd(q, *kv))
        if pending is not None:
            kv = tuple(pending.wait())
    return acc.to(q.dtype), lse


def ring_backward(q, k, v, o, lse, do, mesh):
    """(dq, dk, dv) of the rank's blocks: every hop's K4 on the global O and LSE."""
    dq = dkv = None
    kv = (k, v)
    for hop in range(mesh.seq):
        pending = M.ring_pass(kv, mesh) if hop < mesh.seq - 1 else None
        dq_j, dk_j, dv_j = K.attention_bwd(q, *kv, o, lse, do)
        dq = dq_j.float() if dq is None else dq + dq_j
        # the accumulators of the k/v block held now: the earlier ranks' shares, plus this rank's
        dkv = (dk_j.float(), dv_j.float()) if dkv is None else (dkv[0] + dk_j, dkv[1] + dv_j)
        handed = M.ring_pass(dkv, mesh, tag=2)  # on to the next rank; after the last hop, to the block's owner
        if pending is not None:
            kv = tuple(pending.wait())
        dkv = tuple(handed.wait())
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingAttentionFn(torch.autograd.Function):
    """softmax(q·kᵀ)·v on the rank's token blocks of q, k, v (q pre-scaled),
    over ``mesh``'s seq group: K2 on every forward hop, K4 on every backward
    hop (``ring_forward``, ``ring_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh):
        o, lse = ring_forward(q, k, v, mesh)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh = mesh
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ring_backward(q, k, v, o, lse, do, ctx.mesh), None)


def _plain(q, k, v, heads: int) -> torch.Tensor:
    """The core on the whole tokens, where the ring does not run: plain math at
    or below the size limit (for the batch and heads JAX sees) and on ``meta``;
    above it K2/K4 on the card, query blocks off it."""
    b, _, n, _ = q.shape
    if q.device.type == "meta" or M.global_batch(b) * heads * n * k.shape[2] * 4 <= router._SMALL_LIMIT:
        return router.plain_attention(q, k, v)
    if q.device.type == "cuda":
        if router._records_grad(q, k, v):
            return K.AttentionFn.apply(q, k, v)
        return K.attention_fwd(q, k, v)[0]
    return router.chunked_attention_core(q, k, v)


def ring_mesh(q, k):
    """The registered mesh when q (``(B, H, N, d)``) and k ride its seq ring
    (the JAX core's conditions), else None: no mesh or no seq group, a seq axis
    of 1, N ≠ M, N not a multiple of ``seq``, or ``meta`` tensors."""
    mesh = M.get_attention_mesh()
    n = q.shape[2]
    if (q.device.type == "meta" or mesh is None or mesh.seq <= 1 or mesh.seq_group is None
            or n != k.shape[2] or n % mesh.seq):
        return None
    return mesh


def make_ring_core(axis: str = "seq") -> Callable:
    """An attention core ``(q, k, v, head_local=False) → out`` (q pre-scaled,
    ``(B, H, N, d)``) whose tokens ride the ring of the registered mesh's seq
    axis. ``head_local``: the module holds its rank's heads of a model axis
    (the size rule of the fallback counts the heads JAX sees, all of them)."""
    if axis != "seq":
        raise ValueError(f"ring attention over {axis!r}: the port's ring runs over the 'seq' axis only "
                         "(its data and model ranks hold other rows and heads)")

    def ring(q, k, v, head_local: bool = False):
        mesh = ring_mesh(q, k)
        if mesh is None:
            registered = M.get_attention_mesh()
            heads = q.shape[1] * (registered.model if head_local and registered is not None else 1)
            return _plain(q, k, v, heads)
        q, k, v = (M.split_tokens(t, mesh) for t in (q, k, v))
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            out = RingAttentionFn.apply(q, k, v, mesh)
        else:
            out = ring_forward(q, k, v, mesh)[0]
        return M.gather_tokens(out, mesh)

    return ring
