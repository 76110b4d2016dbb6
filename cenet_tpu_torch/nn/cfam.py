"""CFAM decoder stack: CCU, SRM, MultiOrderDWConv, MCA, CFAModule.

Mirrors ``cenet_tpu/nn/cfam.py`` on NCHW tensors, both reference variants: cenet
(per-level ``mca_rates``, LeakyReLU(0.01) in the image-pool branch) and
cenet_org (rates (6, 12, 18), ReLU pool branch, optional fp32 gating, and the
reference's ``attn``/``crm`` names for ``mca``/``ccu``, ``org_names``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cenet_tpu_torch.core.mesh import global_batch
from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.attention import Nonlocal
from cenet_tpu_torch.nn.blocks import SepConvBN, _Slot
from cenet_tpu_torch.nn.layers import BatchNorm, Conv1d, Conv2d, DropPath, Dropout, GroupNorm, LayerNorm2d, get_act


def build_norm(norm_type: str, dim: int) -> nn.Module:
    """Norm factory (reference ``cfam.py:22-32``): GN is a GroupNorm of one
    channel a group, LN2d a LayerNorm over channels (eps 1e-6); anything else,
    BN and SyncBN among them, one BatchNorm."""
    if norm_type == "GN":
        return GroupNorm(dim, dim, eps=1e-5)
    if norm_type == "LN2d":
        return LayerNorm2d(dim, eps=1e-6)
    return BatchNorm(dim, eps=1e-5)


class SRM(nn.Module):
    """Spatial recalibration (reference ``cfam.py:86-101``): channel max/mean/std maps
    (unbiased std, fp32; ``F.std_sqrt``: no NaN gradient where the channels are
    equal) → pwc + dwc → GELU → BN → sigmoid gate."""

    def __init__(self):
        super().__init__()
        self.pwc = Conv2d(3, 1, 1, bias=False)
        self.dwc = Conv2d(3, 1, 3, padding=1, bias=False)
        self.bn = BatchNorm(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        xf = x.float()
        x_max = xf.amax(dim=1, keepdim=True)
        x_mean = xf.mean(dim=1, keepdim=True)
        x_std = F.std_sqrt((xf - x_mean).square().sum(dim=1, keepdim=True) / max(c - 1, 1))
        u = torch.cat([x_max, x_mean, x_std], dim=1).to(x.dtype)
        f = self.bn(F.gelu(self.pwc(u) + self.dwc(u)))
        return x * torch.sigmoid(f)


class CAggMlp(nn.Module):
    """Channel-aggregation FFN with SRM gate (reference ``cfam.py:104-159``)."""

    def __init__(self, embed_dims: int, feedforward_channels: int, kernel_size: int = 3,
                 act_type: str = "gelu", ffn_drop: float = 0.0):
        super().__init__()
        fc = feedforward_channels
        self.fc1 = Conv2d(embed_dims, fc, 1)
        self.dwconv = Conv2d(fc, fc, kernel_size, padding=kernel_size // 2, groups=fc)
        self.act = get_act(act_type)
        self.drop = Dropout(ffn_drop)
        self.srm = SRM()
        self.fc2 = Conv2d(fc, embed_dims, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(self.act(self.dwconv(self.fc1(x))))
        return self.drop(self.fc2(self.srm(x)))


def _channel_indices(embed_dims: int, channel_split: Sequence[int]):
    """Reference split logic (``cfam.py:178-190``): cumulative int truncation."""
    total = sum(channel_split)
    ratios = [s / total for s in channel_split]
    indices = [(0, int(ratios[0] * embed_dims))]
    for r in ratios[1:]:
        n = int(r * embed_dims)
        if n <= 0:
            raise ValueError("channel split ratio is not correct")
        indices.append((indices[-1][1], indices[-1][1] + n))
    return indices


class MultiOrderDWConv(nn.Module):
    """Dilated multi-branch DWConv + image pooling (reference ``cfam.py:162-241``).

    The channel split is hard-coded [5,5,5,1]/16 as in the reference; three dilated
    SepConvBN branches and a 7×7 image-pool branch (1×1 conv → BN → ``pool_act``,
    LeakyReLU(0.01) by default → ×7 bilinear align-corners, resized back on
    mismatch), concat → 1×1 conv. A dilated branch's padding may exceed its map
    (the org CFAM's rate 18 at 7² and 14²): zero padding, as in the reference.
    Torch keys: ``dlps.{0,1,2}``, pool branch ``dlps.3.1`` (conv), ``dlps.3.2`` (BN).
    """

    def __init__(self, embed_dims: int, rates: Sequence[int] = (6, 12, 18), pool_act: str = "leakyrelu_001"):
        super().__init__()
        self.pool_act = (lambda x: F.leaky_relu(x, 0.01)) if pool_act == "leakyrelu_001" else get_act(pool_act)
        self.indices = _channel_indices(embed_dims, (5, 5, 5, 1))
        dlps = [
            SepConvBN(hi - lo, hi - lo, 3, stride=1, rate=rate, depth_activation=True, epsilon=1e-5)
            for rate, (lo, hi) in zip(rates, self.indices[:3])
        ]
        lo, hi = self.indices[3]
        ipd = hi - lo
        dlps.append(nn.Sequential(_Slot(), Conv2d(ipd, ipd, 1, bias=False), BatchNorm(ipd, eps=1e-5)))
        self.dlps = nn.ModuleList(dlps)
        self.PW_conv = Conv2d(embed_dims, embed_dims, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        outs = [self.dlps[i](x[:, lo:hi]) for i, (lo, hi) in enumerate(self.indices[:3])]
        lo, hi = self.indices[3]
        pool = self.dlps[3]
        p = F.adaptive_avg_pool2d(x[:, lo:hi], (7, 7))
        p = self.pool_act(pool[2](pool[1](p)))
        p = F.resize_bilinear_by_scale(p, 7.0, align_corners=True)
        if p.shape[2] != H or p.shape[3] != W:
            p = F.resize_bilinear(p, (H, W), align_corners=False)
        outs.append(p)
        return self.PW_conv(torch.cat(outs, dim=1))


class CCU(nn.Module):
    """Style-based channel recalibration (reference ``cfam.py:244-264``).

    Per-channel (max, mean, biased std) → grouped Conv1d(k=3) → ReLU → grouped
    Conv1d(k=1) → BatchNorm1d, skipped when the (global) batch is 1 → sigmoid gate. The
    std is ``F.std_sqrt``'s: where a channel is constant over an image its
    gradient is 0, not the NaN of ``sqrt`` at 0 (the JAX package's and the
    reference's).
    Weights are in torch Conv1d layout (``fc1.weight`` (hs·C, 1, 3), ``fc2.weight`` (C, hs, 1)).
    """

    def __init__(self, channel: int, hidden_scale: int = 3):
        super().__init__()
        self.hs = hidden_scale
        # the reference's grouped Conv1d layers; forward reads their weights
        self.fc1 = Conv1d(channel, hidden_scale * channel, 3, groups=channel, bias=False)
        self.fc2 = Conv1d(hidden_scale * channel, channel, 1, groups=channel, bias=False)
        self.bn = BatchNorm(channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[1]
        xf = x.float()
        x_max = xf.amax(dim=(2, 3))
        x_mean = xf.mean(dim=(2, 3))
        x_std = F.std_sqrt((xf - x_mean[:, :, None, None]).square().mean(dim=(2, 3)))
        u = torch.stack([x_max, x_mean, x_std], dim=-1).to(x.dtype)  # (B, C, 3)
        w1 = self.fc1.weight.reshape(c, self.hs, 3).to(x.dtype)
        z1 = F.relu(torch.einsum("bct,cjt->bcj", u, w1))
        z = torch.einsum("bcj,cj->bc", z1, self.fc2.weight[..., 0].to(x.dtype))
        if global_batch(b) > 1:  # the JAX test sees the global batch
            z = self.bn(z)
        g = torch.sigmoid(z.float()).to(x.dtype)
        return x * g[:, :, None, None]


class MCA(nn.Module):
    """Multi-scale contextual aggregation (reference ``cfam.py:267-306``): CCU →
    SiLU(gate)·SiLU(MultiOrderDWConv) → 1×1 proj → residual → Nonlocal denoising.
    ``attn_force_fp32`` multiplies the two activations in fp32 and casts back;
    ``org_names`` keeps the CCU under the cenet_org reference's name ``crm``."""

    def __init__(self, embed_dims: int, rates: Sequence[int] = (2, 3, 4), attn_act_type: str = "silu",
                 attn_force_fp32: bool = False, pool_act: str = "leakyrelu_001", attn_impl: str = "xla",
                 org_names: bool = False):
        super().__init__()
        self.ccu_name = "crm" if org_names else "ccu"
        setattr(self, self.ccu_name, CCU(embed_dims))
        self.gate = Conv2d(embed_dims, embed_dims, 1)
        self.value = MultiOrderDWConv(embed_dims, rates, pool_act=pool_act)
        self.act = get_act(attn_act_type)
        self.attn_force_fp32 = attn_force_fp32
        self.proj_2 = Conv2d(embed_dims, embed_dims, 1)
        self.denoising_module = Nonlocal(embed_dims, attn_impl=attn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = getattr(self, self.ccu_name)(x)
        g, v = self.act(self.gate(x)), self.act(self.value(x))
        gv = (g.float() * v.float()).to(x.dtype) if self.attn_force_fp32 else g * v
        return self.denoising_module(self.proj_2(gv) + shortcut)


class CFAModule(nn.Module):
    """CFAM block (reference ``cfam.py:309-374``): pre-norm MCA and pre-norm channel
    MLP, each with a layer-scale residual (``layer_scale_{1,2}`` of shape (1, C, 1, 1)).
    ``org_names`` keeps the MCA under the cenet_org reference's name ``attn``."""

    def __init__(self, embed_dims: int, ffn_ratio: float = 4.0, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, act_type: str = "gelu", norm_type: str = "BN",
                 init_value: float = 1e-5, attn_act_type: str = "silu",
                 mca_rates: Sequence[int] = (6, 12, 18), attn_force_fp32: bool = False,
                 pool_act: str = "leakyrelu_001", attn_impl: str = "xla", org_names: bool = False):
        super().__init__()
        self.norm1 = build_norm(norm_type, embed_dims)
        self.mca_name = "attn" if org_names else "mca"
        setattr(self, self.mca_name, MCA(embed_dims, rates=mca_rates, attn_act_type=attn_act_type,
                                         attn_force_fp32=attn_force_fp32, pool_act=pool_act, attn_impl=attn_impl,
                                         org_names=org_names))
        self.norm2 = build_norm(norm_type, embed_dims)
        self.mlp = CAggMlp(embed_dims, int(embed_dims * ffn_ratio), 3, act_type, drop_rate)
        self.layer_scale_1 = nn.Parameter(torch.full((1, embed_dims, 1, 1), init_value))
        self.layer_scale_2 = nn.Parameter(torch.full((1, embed_dims, 1, 1), init_value))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, self.mca_name)(self.norm1(x))
        x = x + self.drop_path(self.layer_scale_1.to(y.dtype) * y)
        y = self.mlp(self.norm2(x))
        return x + self.drop_path(self.layer_scale_2.to(y.dtype) * y)
