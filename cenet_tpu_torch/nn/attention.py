"""Attention modules: PVT spatial-reduction attention, differential attention, non-local.

Mirrors ``cenet_tpu/nn/attention.py``. ``attn_impl`` takes the JAX package's
names (:func:`get_attention_core`): ``'xla'`` selects the naive full-map path
(the parity path of the JAX package), ``'chunked'`` the JAX package's
query-block scan of the same numerics (``router.chunked_attention_core``),
``'pallas'`` the routes of :mod:`cenet_tpu_torch.ops.router`,
which send large maps on the card to the CUDA kernels, and ``'ring'`` the
ring attention of :mod:`cenet_tpu_torch.ops.ring_attention` over a mesh's
``seq`` axis (K2 and K4 on every hop on the card).

Tensor parallelism: :class:`SRAAttention`, :class:`MultiheadDiffAttn` and
:class:`MultiheadDiffAttnCross` take their rank's heads in ``shard_heads_(mesh)``
when the mesh's model axis divides them (``core/mesh.py::shard_model_``), as
JAX's ``TP_ATTENTION_RULES`` shard them: q/k/v (and SRA's q, and both halves
of its kv) are column-parallel and keep their rows of the weights, the
output projection is row-parallel and keeps its columns. Their inputs pass
``copy_to_model`` (gradients summed over the model group), the output
projection's partial products ``reduce_from_model`` (its bias added once
after), and λ stays whole with its gradient summed over the group. The cores
run on the local heads with ``head_local=True``. A module whose heads do not
divide stays replicated.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.layers import TRUNC_NORMAL, BatchNorm, Conv2d, Dropout, LayerNorm, Linear, RMSNorm
from cenet_tpu_torch.ops import ring_attention, rotary, router


def get_attention_core(impl: str) -> Callable:
    """The attention core an ``attn_impl`` names, as
    ``cenet_tpu/nn/attention.py::get_attention_core`` maps them: ``'xla'``
    gives plain math, ``'chunked'`` the query-block scan
    (``router.chunked_attention_core``: the naive numerics in blocks of 512
    query rows, never a whole map, never a kernel), ``'pallas'`` the routed
    core. An ``'@axis'`` suffix wraps the core in
    ``router.shard_heads``, which is the bare core unless a registered mesh's
    axis divides the heads. ``'ring'`` and ``'ring@seq'`` give the ring core
    over the mesh's seq axis (``ops/ring_attention.py::make_ring_core``, whose
    '@axis' names the token axis, not a head axis); any other name raises
    ``ValueError``."""
    core, axis = router.parse_impl(impl)
    if core not in ("xla", "chunked", "pallas", "ring"):
        raise ValueError(f"unknown attention impl: {impl}")
    if core == "ring":
        return ring_attention.make_ring_core(axis or "seq")
    bare = {"xla": router.plain_attention, "chunked": router.chunked_attention_core,
            "pallas": router.flash_attention_core}[core]
    return router.shard_heads(bare, axis)


def _local_core(impl: str) -> Callable:
    """The bare core of ``impl`` for a head-sharded module's local heads (the
    routed and ring cores told so: their size rules count the heads JAX sees)."""
    name = router.parse_impl(impl)[0]
    core = get_attention_core(name)
    return core if name in ("xla", "chunked") else functools.partial(core, head_local=True)


def _shard_param_(module: nn.Module, key: str, dim: int, parts: int, mesh: "M.Mesh") -> None:
    """Replace ``module``'s parameter ``key`` (``"q.weight"``) by the rank's piece."""
    owner_name, name = key.rsplit(".", 1)
    owner = module.get_submodule(owner_name)
    p = getattr(owner, name)
    if p is None:
        return
    setattr(owner, name, nn.Parameter(M.shard_tensor(p.detach(), dim, parts, mesh.m, mesh.model),
                                      requires_grad=p.requires_grad))
    if isinstance(owner, nn.Linear) and name == "weight":
        owner.out_features, owner.in_features = owner.weight.shape


class _HeadSharded:
    """``shard_heads_`` and the row-parallel output of the head-sharded modules;
    ``TP_PLAN`` maps their parameters to (dim, parts) as ``TP_ATTENTION_RULES`` does."""

    TP_PLAN: Dict[str, Tuple[int, int]] = {}
    tp: Optional["M.Mesh"] = None  # the mesh whose model axis holds the heads, once sharded

    def _divides(self, model: int) -> bool:
        return self.num_heads % model == 0

    def shard_heads_(self, mesh: "M.Mesh") -> bool:
        """Keep the rank's heads when ``mesh.model`` divides them; whether it did."""
        if mesh.model == 1 or not self._divides(mesh.model):
            return False
        for key, (dim, parts) in self.TP_PLAN.items():
            _shard_param_(self, key, dim, parts, mesh)
        self.tp = mesh
        return True

    def _group(self):
        return None if self.tp is None else self.tp.model_group

    def _heads(self, h: int) -> int:
        return h if self.tp is None else h // self.tp.model

    def _row_parallel(self, proj: "Linear", x: torch.Tensor) -> torch.Tensor:
        """``proj(x)`` where x holds the rank's input columns: the partial
        product summed over the model group, the bias added once."""
        if self.tp is None:
            return proj(x)
        y = M.reduce_from_model(torch.nn.functional.linear(x, proj.weight.to(x.dtype)), self._group())
        return y if proj.bias is None else y + proj.bias.to(x.dtype)


class SRAAttention(_HeadSharded, nn.Module):
    """PVTv2 spatial-reduction attention (reference ``pvtv2.py:50-109``) on tokens
    (B, N, C) of an H×W map; with ``sr_ratio > 1`` the KV stream is downsampled by
    a strided conv and a LayerNorm first. ``attn_drop`` drops attention weights
    after the softmax in train mode, which only the naive ``'xla'`` path
    materialises (``cenet_tpu/nn/attention.py:98-113``: other impls raise);
    ``proj_drop`` drops the projected output. Head-sharded over a mesh's model
    axis when it divides ``num_heads`` (see the module's docstring)."""

    TP_PLAN = {"q.weight": (0, 1), "q.bias": (0, 1), "kv.weight": (0, 2), "kv.bias": (0, 2), "proj.weight": (1, 1)}

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, sr_ratio: int = 1, attn_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.sr_ratio = sr_ratio
        self.attn_impl = attn_impl
        self.q = Linear(dim, dim, bias=qkv_bias, weight_init=TRUNC_NORMAL, bias_init="zeros")
        self.kv = Linear(dim, dim * 2, bias=qkv_bias, weight_init=TRUNC_NORMAL, bias_init="zeros")
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim, weight_init=TRUNC_NORMAL, bias_init="zeros")
        self.proj_drop = Dropout(proj_drop)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio, weight_init="fan_out")
            self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        h = self._heads(self.num_heads)
        hd = C // self.num_heads
        scale = F.round_to(self.qk_scale or hd**-0.5, x.dtype)
        q = self.q(M.copy_to_model(x, self._group())).reshape(B, N, h, hd).transpose(1, 2)
        if self.sr_ratio > 1:
            x_ = x.transpose(1, 2).reshape(B, C, H, W)
            x_ = self.sr(x_).flatten(2).transpose(1, 2)
            x_ = self.norm(x_)
        else:
            x_ = x
        kv = self.kv(M.copy_to_model(x_, self._group())).reshape(B, x_.shape[1], 2, h, hd).permute(2, 0, 3, 1, 4)
        if self.attn_drop.rate > 0.0 and self.training:
            if self.attn_impl != "xla":
                raise NotImplementedError(f"attn_drop={self.attn_drop.rate} > 0 requires attn_impl='xla': the other "
                                          "cores never materialise the attention weights")
            if self.tp is not None:
                raise NotImplementedError("attn_drop > 0 on head-sharded weights: the masks would not be the "
                                          "one process's")
            weights = F.softmax_fp32(torch.matmul(q * scale, kv[0].transpose(-1, -2)))
            out = torch.matmul(self.attn_drop(weights), kv[1])
        else:
            core = get_attention_core(self.attn_impl) if self.tp is None else _local_core(self.attn_impl)
            out = core(q * scale, kv[0], kv[1])
        return self.proj_drop(self._row_parallel(self.proj, out.transpose(1, 2).reshape(B, N, h * hd)))


def lambda_init_fn(depth: int) -> float:
    """Reference ``multihead_diffattn.py:28-29``."""
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


def diff_attention_naive(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lam: torch.Tensor,
                         rel_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's naive diff attention on the interleaved layout (q/k
    ``(B, 2h, N, d)``, v ``(B, h, M, dv)``): full (B, 2h, N, M) maps in the
    reference's order of ops, with its (no-op on finite inputs) nan_to_num; the
    two groups' weights are merged (plus ``rel_pos``) before one product with v."""
    b, h2, n, _ = qs.shape
    logits = torch.nan_to_num(torch.matmul(qs, k.transpose(-1, -2)))
    weights = F.softmax_fp32(logits).reshape(b, h2 // 2, 2, n, k.shape[2])
    weights = weights[:, :, 0] - lam * weights[:, :, 1]
    if rel_pos is not None:
        weights = weights + rel_pos
    return torch.matmul(weights, v)


_DIFF_TP_PLAN = {"q_proj.weight": (0, 1), "k_proj.weight": (0, 1), "v_proj.weight": (0, 1), "out_proj.weight": (1, 1)}


def _lambda_full(mod: nn.Module, group, dtype: torch.dtype) -> torch.Tensor:
    """exp(λ_q1·λ_k1) − exp(λ_q2·λ_k2) + λ_init in ``dtype``; on a head-sharded
    module the λ vectors pass ``copy_to_model`` together, so their gradient is
    the sum of every rank's heads'."""
    q1, k1, q2, k2 = mod.lambda_q1, mod.lambda_k1, mod.lambda_q2, mod.lambda_k2
    if group is not None:
        q1, k1, q2, k2 = M.copy_to_model(torch.stack([q1, k1, q2, k2]), group).unbind(0)
    lambda_1 = torch.exp(torch.sum(q1 * k1))
    lambda_2 = torch.exp(torch.sum(q2 * k2))
    return (lambda_1 - lambda_2 + mod.lambda_init).to(dtype)


class MultiheadDiffAttn(_HeadSharded, nn.Module):
    """DIFF-Transformer attention (reference ``multihead_diffattn.py:32-129``).

    Non-causal; the two softmax groups (even/odd interleaved heads) combine as
    A₁ − λ·A₂ with the reparameterised λ (an fp32 island), then an affine-free
    fp32 RMSNorm and ×(1 − λ_init). Optional GQA via ``num_kv_heads``.

    ``forward(x, rel_pos)`` takes the JAX module's optional ``rel_pos``. With
    ``use_rotary`` it is the (cos, sin) tables of :func:`rotary.make_rotary_tables`,
    and interleaved rotary turns q and k before the attention. Without
    ``use_rotary`` it is a bias added to the combined weights A₁ − λ·A₂, which
    takes the naive full-map path. Neither adds a parameter. Head-sharded over
    a mesh's model axis when it divides both head counts: each rank keeps
    whole pairs of interleaved q/k heads (``2h % (2·model) == 0``).
    """

    TP_PLAN = _DIFF_TP_PLAN

    def __init__(self, embed_dim: int, depth: int, num_heads: int, num_kv_heads: int = None,
                 attn_impl: str = "xla", use_rotary: bool = False):
        super().__init__()
        self.use_rotary = use_rotary
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.n_rep = num_heads // self.num_kv_heads
        self.head_dim = embed_dim // num_heads // 2
        self.lambda_init = lambda_init_fn(depth)
        self.attn_impl = attn_impl
        self.q_proj = Linear(embed_dim, embed_dim, bias=False)
        self.k_proj = Linear(embed_dim, embed_dim // self.n_rep, bias=False)
        self.v_proj = Linear(embed_dim, embed_dim // self.n_rep, bias=False)
        self.out_proj = Linear(embed_dim, embed_dim, bias=False)
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            setattr(self, name, nn.Parameter(torch.empty(self.head_dim)))
        self.subln = RMSNorm(2 * self.head_dim, eps=1e-5, affine=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The λ vectors ~ N(0, 0.1²) (the projections reset themselves)."""
        with torch.no_grad():
            for t in (self.lambda_q1, self.lambda_k1, self.lambda_q2, self.lambda_k2):
                t.normal_(0.0, 0.1, generator=generator)

    def _divides(self, model: int) -> bool:
        return self.num_heads % model == 0 and self.num_kv_heads % model == 0

    def forward(self, x: torch.Tensor, rel_pos=None) -> torch.Tensor:
        B, N, E = x.shape
        h, hkv, hd = self._heads(self.num_heads), self._heads(self.num_kv_heads), self.head_dim
        xc = M.copy_to_model(x, self._group())
        q = self.q_proj(xc).reshape(B, N, 2 * h, hd).transpose(1, 2)
        k = self.k_proj(xc).reshape(B, N, 2 * hkv, hd).transpose(1, 2)
        v = self.v_proj(xc).reshape(B, N, hkv, 2 * hd).transpose(1, 2)
        if self.use_rotary and rel_pos is not None:
            cos, sin = rel_pos
            q = rotary.apply_rotary_emb(q, cos, sin, interleaved=True)
            k = rotary.apply_rotary_emb(k, cos, sin, interleaved=True)
        if self.n_rep > 1:
            k = k.repeat_interleave(self.n_rep, dim=1)
            v = v.repeat_interleave(self.n_rep, dim=1)

        lambda_full = _lambda_full(self, self._group(), x.dtype)

        qs = q * F.round_to(hd**-0.5, q.dtype)
        bias = rel_pos is not None and not self.use_rotary
        core = router.parse_impl(self.attn_impl)[0]
        if core == "xla" or bias:
            attn = diff_attention_naive(qs, k, v, lambda_full, rel_pos if bias else None)
        else:
            get_attention_core(self.attn_impl)  # raises on an unknown name
            if core == "chunked":
                # the JAX router's split groups: plain math up to its limit, scanned above
                attn = router.diff_attention_chunked(qs[:, 0::2], k[:, 0::2], qs[:, 1::2], k[:, 1::2], v,
                                                     lambda_full.float(), head_local=self.tp is not None)
            else:
                attn = router.diff_attention_interleaved(qs, k, v, lambda_full.float(), head_local=self.tp is not None,
                                                         impl=self.attn_impl)

        attn = self.subln(attn) * (1 - self.lambda_init)
        attn = attn.transpose(1, 2).reshape(B, N, h * 2 * hd)
        return self._row_parallel(self.out_proj, attn)


class MultiheadDiffAttnCross(_HeadSharded, nn.Module):
    """Cross-attention differential attention (reference
    ``multihead_diffattn.py:131-367``; ``cenet_tpu/nn/attention.py:246-312``).

    ``variant`` "v1" takes the query from ``q_src`` (the decoder) and, on maps,
    adds the source ``x`` back; "v2" adds nothing. With ``spatial`` set, ``x`` and
    ``q_src`` are NCHW maps tokenised by the reference's raw ``.view``. Each
    softmax group goes through the attention core with the shared v (dv = 2d):
    the query-block scan for ``'xla'`` and ``'chunked'`` (JAX turns ``'xla'``
    into ``'chunked'`` here, ``cenet_tpu/nn/attention.py:298-300``), the routed
    core (K2 on the card above the router's limit) for ``'pallas'``, the ring
    for ``'ring'``. Head-sharded over a mesh's model axis when it divides
    ``num_heads``.
    """

    TP_PLAN = _DIFF_TP_PLAN

    def __init__(self, embed_dim: int, depth: int, num_heads: int, variant: str = "v1",
                 spatial: Optional[int] = None, attn_impl: str = "xla"):
        super().__init__()
        self.variant, self.spatial = variant, spatial
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads // 2
        self.lambda_init = lambda_init_fn(depth)
        impl, axis = router.parse_impl(attn_impl)
        self.core_impl = ("chunked" + (f"@{axis}" if axis else "")) if impl == "xla" else attn_impl
        self.q_proj = Linear(embed_dim, embed_dim, bias=False)
        self.k_proj = Linear(embed_dim, embed_dim, bias=False)
        self.v_proj = Linear(embed_dim, embed_dim, bias=False)
        self.out_proj = Linear(embed_dim, embed_dim, bias=False)
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            setattr(self, name, nn.Parameter(torch.empty(self.head_dim)))
        self.subln = RMSNorm(2 * self.head_dim, eps=1e-5, affine=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The λ vectors ~ N(0, 0.1²) (the projections reset themselves)."""
        with torch.no_grad():
            for t in (self.lambda_q1, self.lambda_k1, self.lambda_q2, self.lambda_k2):
                t.normal_(0.0, 0.1, generator=generator)

    def forward(self, x: torch.Tensor, q_src: torch.Tensor) -> torch.Tensor:
        from cenet_tpu_torch.nn.dseb import tokenize_torch_view, untokenize_torch_view

        spatial = self.spatial is not None and x.ndim == 4
        x_res = x if self.variant == "v1" else q_src
        if spatial:
            h, w = x.shape[2], x.shape[3]
            x_tok, q_tok = tokenize_torch_view(x), tokenize_torch_view(q_src)
        else:
            x_tok, q_tok = x, q_src
        B, N, E = x_tok.shape
        hn, hd = self._heads(self.num_heads), self.head_dim
        group = self._group()
        x_tok, q_tok = M.copy_to_model(x_tok, group), M.copy_to_model(q_tok, group)
        q = self.q_proj(q_tok).reshape(B, N, 2 * hn, hd).transpose(1, 2)
        k = self.k_proj(x_tok).reshape(B, N, 2 * hn, hd).transpose(1, 2)
        v = self.v_proj(x_tok).reshape(B, N, hn, 2 * hd).transpose(1, 2)
        lambda_full = _lambda_full(self, group, x_tok.dtype)
        core = get_attention_core(self.core_impl) if self.tp is None else _local_core(self.core_impl)
        qs = q * F.round_to(hd**-0.5, q.dtype)
        attn = core(qs[:, 0::2], k[:, 0::2], v) - lambda_full * core(qs[:, 1::2], k[:, 1::2], v)
        attn = self.subln(attn) * (1 - self.lambda_init)
        attn = self._row_parallel(self.out_proj, attn.transpose(1, 2).reshape(B, N, hn * 2 * hd))
        if spatial:
            attn = untokenize_torch_view(attn, h, w)
            if self.variant == "v1":
                attn = attn + x_res
        return attn


class Nonlocal(nn.Module):
    """Non-local denoising block (reference ``modules/nlb.py:8-148``): θ/φ/g 1×1
    convs, an HW×HW affinity, output conv + BN, and the learnable blend
    z = (1−w)·x + w·p. ``instantiation`` "softmax" normalises the affinity by a
    softmax with C^-0.5 scale through the attention core (K2 on the card above
    the router's limit); "dot_product" divides it by HW, in plain math."""

    def __init__(self, dim: int, instantiation: str = "softmax", attn_impl: str = "xla"):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(instantiation)
        self.instantiation = instantiation
        self.attn_impl = attn_impl
        self.conv_theta = Conv2d(dim, dim, 1)
        self.conv_phi = Conv2d(dim, dim, 1)
        self.conv_g = Conv2d(dim, dim, 1)
        self.conv_out = Conv2d(dim, dim, 1)
        self.bn = BatchNorm(dim, eps=1e-5)
        self.w = nn.Parameter(torch.tensor(0.5))

    def _tokens(self, conv: Conv2d, tok: torch.Tensor) -> torch.Tensor:
        # a 1×1 conv on (B, HW, C) tokens: the same product, and the result is
        # token-major with a unit-stride channel dim, as the kernel takes it
        w = conv.weight.flatten(1).to(tok.dtype)
        return torch.nn.functional.linear(tok, w, conv.bias.to(tok.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        tok = x.flatten(2).transpose(1, 2)
        theta = self._tokens(self.conv_theta, tok)
        phi = self._tokens(self.conv_phi, tok)
        g = self._tokens(self.conv_g, tok)
        if self.instantiation == "softmax":
            core = get_attention_core(self.attn_impl)
            out = core((theta * F.round_to(C**-0.5, theta.dtype))[:, None], phi[:, None], g[:, None])[:, 0]
        else:
            out = torch.matmul(torch.matmul(theta, phi.transpose(1, 2)) / (H * W), g)
        p = out.transpose(1, 2).reshape(B, C, H, W)
        p = self.bn(self.conv_out(p))
        w = self.w.to(x.dtype)
        return (1 - w) * x + w * p


class WeightedNonLocalBlock(nn.Module):
    """Weighted non-local variant (reference ``modules/nlb.py:151-191``): a softmax
    affinity of down-projected θ/φ scaled by ic^-0.5 (fp32 softmax, plain math),
    the value path g, an output conv + BN, and the learnable blend w."""

    def __init__(self, in_channels: int, inter_channels: int):
        super().__init__()
        self.theta = Conv2d(in_channels, inter_channels, 1)
        self.phi = Conv2d(in_channels, inter_channels, 1)
        self.g = Conv2d(in_channels, inter_channels, 1)
        self.out = Conv2d(inter_channels, in_channels, 1)
        self.bn = BatchNorm(in_channels)
        self.w = nn.Parameter(torch.tensor(0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        ic = self.theta.out_channels

        def tokens(conv):
            return conv(x).flatten(2).transpose(1, 2)  # (B, HW, ic)

        theta, phi, g = tokens(self.theta), tokens(self.phi), tokens(self.g)
        aff = F.softmax_fp32(torch.matmul(theta, phi.transpose(1, 2)) * F.round_to(ic**-0.5, x.dtype))
        y = torch.matmul(aff, g).transpose(1, 2).reshape(B, ic, H, W)
        y = self.bn(self.out(y))
        w = self.w.to(x.dtype)
        return (1 - w) * x + w * y
