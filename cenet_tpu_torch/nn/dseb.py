"""DSEB: Dual Selective Enhancement Block for skip connections (NCHW).

Mirrors ``cenet_tpu/nn/dseb.py``: the ``use_command`` modes 'no', 'dat',
'fea', 'dog' and 'seq' and their combinations (default 'dat-fea'), and the
cenet_org ``SkipEnhancer`` with its ``DoGEdge``.

Tokenisation quirk, kept exactly: the reference tokenises NCHW maps with a raw
``.view(B, HW, C)`` (``dseb.py:114-118``), a memory reinterpretation that mixes
channels and space. On a contiguous NCHW tensor that is ``reshape(B, H*W, C)``;
a "tidy" permute would break parity with reference checkpoints.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as tF

from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.attention import MultiheadDiffAttn
from cenet_tpu_torch.nn.layers import Conv2d


class FEA(nn.Module):
    """Feature Edge Amplification (reference ``dseb.py:26-76``): per scale s,
    edge_s = |x − up(down(x, s))|; output x + w · mean over pairs |edge_i − edge_j|,
    with the gate ``w`` of shape (1, C, 1, 1)."""

    def __init__(self, dim: int, scale_factors: Sequence[float]):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self.w = nn.Parameter(torch.empty(1, dim, 1, 1))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The gate ``w`` ~ N(0.5, 1)."""
        with torch.no_grad():
            self.w.normal_(0.5, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        n = len(self.scale_factors)
        m = n * (n - 1) // 2
        edges = []
        for s in self.scale_factors:
            x1 = F.resize_bilinear_by_scale(x, float(s), align_corners=False)
            x1 = F.resize_bilinear(x1, (H, W), align_corners=False)
            edges.append(torch.abs(x - x1))
        w_edge = torch.zeros_like(x)
        for i in range(n):
            for j in range(i + 1, n):
                w_edge = w_edge + (1.0 / m) * torch.abs(edges[i] - edges[j])
        return x + self.w.to(x.dtype) * w_edge


def tokenize_torch_view(x: torch.Tensor) -> torch.Tensor:
    """The reference's raw NCHW ``.view(B, HW, C)``."""
    b, c, h, w = x.shape
    return x.contiguous().reshape(b, h * w, c)


def untokenize_torch_view(tok: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse raw ``.view(B, C, H, W)``."""
    b, n, c = tok.shape
    return tok.reshape(b, c, h, w)


def gaussian_smooth_3x3(x: torch.Tensor, sigma_raw: torch.Tensor) -> torch.Tensor:
    """Depthwise 3×3 Gaussian with σ = 2·sigmoid(raw) per channel (reference
    ``dseb.py:120-146``). The reference normalises its (1, C, 3, 3) kernel by a
    sum over channels for each tap (``dseb.py:135``), not over a channel's nine
    taps, so a channel's kernel does not sum to 1; kept as it is."""
    sigma = 2.0 * torch.sigmoid(sigma_raw)
    coords = torch.tensor([-1.0, 0.0, 1.0], device=x.device)
    gx = coords[:, None] ** 2 + coords[None, :] ** 2
    kernel = torch.exp(-gx[None] / (2.0 * sigma.square()[:, None, None]))  # (C, 3, 3)
    kernel = kernel / kernel.sum(dim=0, keepdim=True)
    return tF.conv2d(x, kernel[:, None].to(x.dtype), padding=1, groups=x.shape[1])


class DSEBlock(nn.Module):
    """Dual Selective Enhancement skip block (reference ``dseb.py:79-165``). The
    'dog' branch's learnable σs are ``sigma_raw_1`` ~ N(−0.4, 1) and
    ``sigma_raw_2`` ~ N(0, 1), one per channel."""

    def __init__(self, dim: int, scale_factors: Sequence[float], num_heads: int, mode: str = "add",
                 use_command: str = "dat-fea", depth: int = 1, attn_impl: str = "xla"):
        super().__init__()
        cmd = use_command.lower()
        self.off = "no" in cmd
        self.use_dat, self.use_fea, self.use_dog, self.do_seq = ("dat" in cmd, "fea" in cmd, "dog" in cmd,
                                                                 "seq" in cmd)
        self.mode = mode.lower()
        _dim = dim * 2 if self.mode == "cat" else dim
        if self.use_fea:
            self.boundary = FEA(_dim, scale_factors)
        if self.use_dog:
            self.sigma_raw_1 = nn.Parameter(torch.empty(_dim))
            self.sigma_raw_2 = nn.Parameter(torch.empty(_dim))
        if self.use_dat:
            self.diffattn = MultiheadDiffAttn(_dim, depth=depth, num_heads=num_heads, attn_impl=attn_impl)
        self.mixer = Conv2d(_dim, dim, 1, bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The DoG branch's σs (its submodules reset themselves)."""
        if self.use_dog:
            with torch.no_grad():
                self.sigma_raw_1.normal_(-0.4, 1.0, generator=generator)
                self.sigma_raw_2.normal_(0.0, 1.0, generator=generator)

    def forward(self, skip: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        if self.off:
            return skip
        y = dec + skip if self.mode == "add" else torch.cat([dec, skip], dim=1)
        x_fea = self.boundary(y) + y if self.use_fea else 0
        if self.use_dog:
            x_dog = gaussian_smooth_3x3(y, self.sigma_raw_1) - gaussian_smooth_3x3(y, self.sigma_raw_2) + y
        else:
            x_dog = 0
        if self.do_seq:
            y = x_fea + x_dog if (self.use_fea or self.use_dog) else y
            x_fea = x_dog = 0
        if self.use_dat:
            diff = self.diffattn(tokenize_torch_view(y))
            x_dat = untokenize_torch_view(diff, y.shape[2], y.shape[3]) * y
        else:
            x_dat = 0
        z = x_fea + x_dog + x_dat if (self.use_fea or self.use_dog or self.use_dat) else y
        return self.mixer(z) + skip


class DoGEdge(nn.Module):
    """Two-scale difference edge (cenet_org, ``cenet_org/decoders.py:112-125``):
    x + w·|up(down(x, s₀)) − up(down(x, s₁))|, the gate ``w`` (1, C, 1, 1) at 0.5."""

    def __init__(self, dim: int, scale_factors: Sequence[float]):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self.w = nn.Parameter(torch.full((1, dim, 1, 1), 0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        x1, x2 = (F.resize_bilinear(F.resize_bilinear_by_scale(x, float(s), align_corners=False), (H, W),
                                    align_corners=False) for s in self.scale_factors[:2])
        return x + self.w.to(x.dtype) * torch.abs(x1 - x2)


class SkipEnhancer(nn.Module):
    """cenet_org skip block (``cenet_org/decoders.py:128-146``): DoGEdge → diff
    attention (depth 1) times the tokens → y + diff → 1×1 proj (cat mode) → + skip."""

    def __init__(self, dim: int, scale_factors: Sequence[float], num_heads: int, mode: str = "add",
                 attn_impl: str = "xla"):
        super().__init__()
        self.mode = mode.lower()
        _dim = dim * 2 if self.mode == "cat" else dim
        self.boundary = DoGEdge(_dim, scale_factors)
        self.diffattn = MultiheadDiffAttn(_dim, depth=1, num_heads=num_heads, attn_impl=attn_impl)
        if self.mode == "cat":
            self.proj = Conv2d(_dim, dim, 1, bias=True)

    def forward(self, skip: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        y = dec + skip if self.mode == "add" else torch.cat([dec, skip], dim=1)
        y = self.boundary(y)
        tok = tokenize_torch_view(y)
        diff = untokenize_torch_view(self.diffattn(tok) * tok, y.shape[2], y.shape[3])
        z = y + diff
        if self.mode == "cat":
            z = self.proj(z)
        return z + skip
