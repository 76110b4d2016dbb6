"""Attention modules: PVT spatial-reduction attention, differential attention, non-local.

Mirrors ``cenet_tpu/nn/attention.py``. ``attn_impl`` takes the JAX package's
names (:func:`get_attention_core`): ``'xla'`` selects the naive full-map path
(the parity path of the JAX package), ``'chunked'`` plain math of the same
numerics, and ``'pallas'`` the routes of :mod:`cenet_tpu_torch.ops.router`,
which send large maps on the card to the CUDA kernels.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn

from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.layers import BatchNorm, Conv2d, LayerNorm, Linear, RMSNorm
from cenet_tpu_torch.ops import rotary, router


def get_attention_core(impl: str) -> Callable:
    """The attention core an ``attn_impl`` names, as
    ``cenet_tpu/nn/attention.py::get_attention_core`` maps them: ``'xla'``, and
    ``'chunked'`` (the JAX package's query-block scan, whose numerics are the
    naive ones and which never reaches a kernel), give plain math; ``'pallas'``
    the routed core. ``'ring'`` and an ``'@axis'`` suffix raise
    ``NotImplementedError`` (sequence and tensor parallelism are not ported,
    ROADMAP queue 1 item 10); any other name raises ``ValueError``."""
    core, axis = router.parse_impl(impl)
    if core not in ("xla", "chunked", "pallas", "ring"):
        raise ValueError(f"unknown attention impl: {impl}")
    if core == "ring" or axis is not None:
        raise NotImplementedError(f"attention impl {impl!r}: ring attention and '@axis' tensor parallelism are "
                                  "not ported yet (ROADMAP queue 1 item 10)")
    return router.flash_attention_core if core == "pallas" else router.plain_attention


class SRAAttention(nn.Module):
    """PVTv2 spatial-reduction attention (reference ``pvtv2.py:50-109``) on tokens
    (B, N, C) of an H×W map; with ``sr_ratio > 1`` the KV stream is downsampled by
    a strided conv and a LayerNorm first."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False, sr_ratio: int = 1,
                 attn_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.attn_impl = attn_impl
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        scale = F.round_to(hd**-0.5, x.dtype)
        q = self.q(x).reshape(B, N, h, hd).transpose(1, 2)
        if self.sr_ratio > 1:
            x_ = x.transpose(1, 2).reshape(B, C, H, W)
            x_ = self.sr(x_).flatten(2).transpose(1, 2)
            x_ = self.norm(x_)
        else:
            x_ = x
        M = x_.shape[1]
        kv = self.kv(x_).reshape(B, M, 2, h, hd).permute(2, 0, 3, 1, 4)
        out = get_attention_core(self.attn_impl)(q * scale, kv[0], kv[1])
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


def lambda_init_fn(depth: int) -> float:
    """Reference ``multihead_diffattn.py:28-29``."""
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


class MultiheadDiffAttn(nn.Module):
    """DIFF-Transformer attention (reference ``multihead_diffattn.py:32-129``).

    Non-causal; the two softmax groups (even/odd interleaved heads) combine as
    A₁ − λ·A₂ with the reparameterised λ (an fp32 island), then an affine-free
    fp32 RMSNorm and ×(1 − λ_init). Optional GQA via ``num_kv_heads``.

    ``forward(x, rel_pos)`` takes the JAX module's optional ``rel_pos``. With
    ``use_rotary`` it is the (cos, sin) tables of :func:`rotary.make_rotary_tables`,
    and interleaved rotary turns q and k before the attention. Without
    ``use_rotary`` it is a bias added to the combined weights A₁ − λ·A₂, which
    takes the naive full-map path. Neither adds a parameter.
    """

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

    def forward(self, x: torch.Tensor, rel_pos=None) -> torch.Tensor:
        B, N, E = x.shape
        h, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(B, N, 2 * h, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, N, 2 * hkv, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, N, hkv, 2 * hd).transpose(1, 2)
        if self.use_rotary and rel_pos is not None:
            cos, sin = rel_pos
            q = rotary.apply_rotary_emb(q, cos, sin, interleaved=True)
            k = rotary.apply_rotary_emb(k, cos, sin, interleaved=True)
        if self.n_rep > 1:
            k = k.repeat_interleave(self.n_rep, dim=1)
            v = v.repeat_interleave(self.n_rep, dim=1)

        lambda_1 = torch.exp(torch.sum(self.lambda_q1 * self.lambda_k1))
        lambda_2 = torch.exp(torch.sum(self.lambda_q2 * self.lambda_k2))
        lambda_full = (lambda_1 - lambda_2 + self.lambda_init).to(x.dtype)

        qs = q * F.round_to(hd**-0.5, q.dtype)
        bias = rel_pos is not None and not self.use_rotary
        core = router.parse_impl(self.attn_impl)[0]
        if core == "xla" or bias:
            # naive reference path: full (B, 2h, N, N) maps in the reference's
            # order of ops, with its (no-op on finite inputs) nan_to_num
            logits = torch.nan_to_num(torch.matmul(qs, k.transpose(-1, -2)))
            weights = F.softmax_fp32(logits).reshape(B, h, 2, N, N)
            weights = weights[:, :, 0] - lambda_full * weights[:, :, 1]
            if bias:
                weights = weights + rel_pos
            attn = torch.matmul(weights, v)
        else:
            get_attention_core(self.attn_impl)  # raises on an unknown name, 'ring' and '@axis'
            if core == "chunked":
                # the JAX router's split groups in plain math, never a kernel
                attn = router.diff_attention_plain(qs[:, 0::2], k[:, 0::2], qs[:, 1::2], k[:, 1::2], v,
                                                   lambda_full.float())
            else:
                attn = router.diff_attention_interleaved(qs, k, v, lambda_full.float())

        attn = self.subln(attn) * (1 - self.lambda_init)
        attn = attn.transpose(1, 2).reshape(B, N, h * 2 * hd)
        return self.out_proj(attn)


class Nonlocal(nn.Module):
    """Non-local denoising block (reference ``modules/nlb.py:8-148``): θ/φ/g 1×1
    convs, an HW×HW softmax affinity with C^-0.5 scale, output conv + BN, and the
    learnable blend z = (1−w)·x + w·p."""

    def __init__(self, dim: int, attn_impl: str = "xla"):
        super().__init__()
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
        core = get_attention_core(self.attn_impl)
        out = core((theta * F.round_to(C**-0.5, theta.dtype))[:, None], phi[:, None], g[:, None])[:, 0]
        p = out.transpose(1, 2).reshape(B, C, H, W)
        p = self.bn(self.conv_out(p))
        w = self.w.to(x.dtype)
        return (1 - w) * x + w * p
