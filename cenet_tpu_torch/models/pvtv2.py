"""PVTv2 pyramid vision transformer backbone (reference ``networks/cenet/pvtv2.py``).

Mirrors ``cenet_tpu/models/pvtv2.py``: four stages of OverlapPatchEmbed →
N×(SRA attention + DWConv-MLP) → LayerNorm, returning NCHW maps at strides
4/8/16/32. Tokens inside a stage are (B, N, C). Initial weights are the JAX
package's: N(0, 2/fan_out) for the patch-embedding, DWConv and SRA convs, a
truncated normal of std 0.02 for the linears, zero biases but the SRA conv's.
``remat`` recomputes each block in the backward (``torch.utils.checkpoint``,
as ``nn.remat(PVTBlock)`` does), with the same drop-path masks.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.attention import SRAAttention
from cenet_tpu_torch.nn.layers import TRUNC_NORMAL, Conv2d, DropPath, Dropout, LayerNorm, Linear, _RandomMask


class DWConv(nn.Module):
    """3×3 depthwise conv applied to tokens through an NCHW detour (reference ``pvtv2.py:359-370``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, stride=1, padding=1, groups=dim, bias=True, weight_init="fan_out",
                             bias_init="zeros")

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        y = self.dwconv(x.transpose(1, 2).reshape(B, C, H, W))
        return y.flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    """fc1 → DWConv → GELU → fc2 (reference ``pvtv2.py:12-47``)."""

    def __init__(self, in_features: int, hidden_features: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, weight_init=TRUNC_NORMAL, bias_init="zeros")
        self.dwconv = DWConv(hidden_features)
        self.fc2 = Linear(hidden_features, in_features, weight_init=TRUNC_NORMAL, bias_init="zeros")
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = self.drop(F.gelu(self.dwconv(self.fc1(x), H, W)))
        return self.drop(self.fc2(x))


class PVTBlock(nn.Module):
    """Pre-norm SRA attention + MixFFN with stochastic depth (reference ``pvtv2.py:112-149``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0, sr_ratio: int = 1,
                 attn_impl: str = "xla"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SRAAttention(dim, num_heads=num_heads, qkv_bias=qkv_bias, attn_drop=attn_drop, proj_drop=drop,
                                 sr_ratio=sr_ratio, attn_impl=attn_impl)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), H, W))
        return x + self.drop_path(self.mlp(self.norm2(x), H, W))


def checkpointed_block(blk: PVTBlock, tokens: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``blk(tokens, H, W)`` under ``torch.utils.checkpoint``, recomputed in the
    backward with the masks its forward drew. The checkpoint restores only the
    default generators; drop-path and dropout draw from the generators the
    trainer attaches. So their states are saved here as the block enters its
    forward, set again for the recompute, and put back after it to what they
    were before it: the next microbatch's forward (``grad_accum_steps`` > 1)
    then draws what it draws without ``remat``."""
    gens = list({id(m.generator): m.generator for m in blk.modules()
                 if isinstance(m, _RandomMask) and m.rate > 0 and m.generator is not None}.values())
    entry = [g.get_state() for g in gens]
    calls = 0

    def run(t: torch.Tensor) -> torch.Tensor:
        nonlocal calls
        calls += 1
        if calls == 1 or not gens:
            return blk(t, H, W)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, entry):
            g.set_state(s)
        try:
            return blk(t, H, W)
        finally:  # also when the checkpoint stops the recompute early
            for g, s in zip(gens, now):
                g.set_state(s)

    # the blocks draw from no default generator, so the checkpoint need not stash them
    return checkpoint(run, tokens, use_reentrant=False, preserve_rng_state=False)


class OverlapPatchEmbed(nn.Module):
    """Strided-conv patch embedding + LayerNorm (reference ``pvtv2.py:152-191``)."""

    def __init__(self, patch_size: int, stride: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=stride, padding=patch_size // 2,
                           weight_init="fan_out", bias_init="zeros")
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        _, _, H, W = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), H, W


class PVTv2(nn.Module):
    """Backbone returning the four NCHW stage maps (reference ``pvtv2.py:194-356``).
    Torch keys: ``patch_embed{s}``, ``block{s}.{i}``, ``norm{s}`` for stages s = 1..4.
    With ``remat`` each block is recomputed in the backward
    (:func:`checkpointed_block`) whenever autograd records in train mode; eval
    and inference run the blocks as they are."""

    def __init__(self, in_chans: int = 3, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8), mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 qkv_bias: bool = True, depths: Sequence[int] = (3, 4, 6, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, attn_impl: str = "xla", remat: bool = False):
        super().__init__()
        self.embed_dims = tuple(embed_dims)
        self.remat = remat
        dpr = torch.linspace(0, drop_path_rate, sum(depths)).tolist()
        patch_cfg = [(7, 4, in_chans), (3, 2, embed_dims[0]), (3, 2, embed_dims[1]), (3, 2, embed_dims[2])]
        cur = 0
        for s in range(4):
            ps, st, ic = patch_cfg[s]
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(ps, st, ic, embed_dims[s]))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                PVTBlock(embed_dims[s], num_heads[s], mlp_ratios[s], qkv_bias, drop_rate, attn_drop_rate, dpr[cur + i],
                         sr_ratios[s], attn_impl)
                for i in range(depths[s])
            ))
            setattr(self, f"norm{s + 1}", LayerNorm(embed_dims[s], eps=1e-6))
            cur += depths[s]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for s in range(1, 5):
            tokens, H, W = getattr(self, f"patch_embed{s}")(x if s == 1 else outs[-1])
            for blk in getattr(self, f"block{s}"):
                tokens = checkpointed_block(blk, tokens, H, W) if remat else blk(tokens, H, W)
            tokens = getattr(self, f"norm{s}")(tokens)
            outs.append(tokens.transpose(1, 2).reshape(tokens.shape[0], -1, H, W).contiguous())
        return outs


# Variant registry (reference ``pvtv2.py:384-431``)
PVT_VARIANTS = {
    "pvt_v2_b0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "pvt_v2_b1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "pvt_v2_b2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3)),
    "pvt_v2_b3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3)),
    "pvt_v2_b4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3)),
    "pvt_v2_b5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3), mlp_ratios=(4, 4, 4, 4)),
}


def make_pvt(variant: str, in_chans: int = 3, attn_impl: str = "xla", drop_path_rate: float = 0.1,
             remat: bool = False, **kw) -> PVTv2:
    """A PVTv2 variant; ``kw`` passes ``drop_rate`` and ``attn_drop_rate`` (0 in every reference config)."""
    cfg = dict(PVT_VARIANTS[variant])
    return PVTv2(
        in_chans=in_chans, embed_dims=cfg["embed_dims"], depths=cfg["depths"],
        mlp_ratios=cfg.get("mlp_ratios", (8, 8, 4, 4)), num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
        qkv_bias=True, drop_path_rate=drop_path_rate, attn_impl=attn_impl, remat=remat, **kw,
    )
