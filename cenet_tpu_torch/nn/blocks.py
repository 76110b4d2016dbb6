"""Conv/up block library (NCHW), mirroring ``cenet_tpu/nn/blocks.py``.

Attribute names reproduce the reference torch modules' ``state_dict`` keys:
monai ``Convolution`` wrappers add a trailing ``.conv`` (``conv1.conv.weight``),
and ``nn.Sequential`` containers index their children (EUCB ``up_dwc.1``,
``up_dwc.2``, ``pwc.0``; UpConv ``up.1``, ``up.2``; UpRb ``up.1``; UpTConv
``up.conv``). Initial weights are the JAX blocks' (normal or truncated normal
of std 0.02; UpRb and DownRb re-initialise their UnetResBlock with the normal,
``init_scheme``). ``UnetResBlockS2D`` and the packed 5×5 helpers of
``cenet_tpu/nn/functional.py`` are not ported: they have the same parameters
and the same math as ``UnetResBlock`` and exist for the TPU's layout.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.layers import NORMAL, TRUNC_NORMAL, BatchNorm, Conv2d, ConvTranspose2d, get_act


def _unet_padding(kernel_size: int, stride: int) -> int:
    """monai padding rule (reference ``modules/unet.py:16-28``): (k - s + 1) // 2."""
    return (kernel_size - stride + 1) // 2


class _Slot(nn.Module):
    """A parameter-free placeholder that keeps ``nn.Sequential`` indices aligned
    with the reference (its upsample, pool and activation children)."""

    def forward(self, x):
        return x


class _MonaiConv(nn.Module):
    """monai ``Convolution`` wrapper: the conv sits one level down as ``.conv``
    (a transposed conv with ``transposed``)."""

    def __init__(self, *args, transposed: bool = False, **kw):
        super().__init__()
        self.conv = (ConvTranspose2d if transposed else Conv2d)(*args, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SepConvBN(nn.Module):
    """Dilated depthwise-separable conv + BN (reference ``modules/blocks.py:131-185``).

    depth_activation=True:  dw → BN → relu → pw → BN → relu
    depth_activation=False: relu → dw → BN → pw → BN
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3, stride: int = 1,
                 rate: int = 1, depth_activation: bool = False, epsilon: float = 1e-3):
        super().__init__()
        self.depth_activation = depth_activation
        k_eff = kernel_size + (kernel_size - 1) * (rate - 1)
        self.depthwise = Conv2d(in_channels, in_channels, kernel_size, stride=stride, padding=(k_eff - 1) // 2,
                                dilation=rate, groups=in_channels, bias=False, weight_init=NORMAL)
        self.depthwise_bn = BatchNorm(in_channels, eps=epsilon)
        self.pointwise = Conv2d(in_channels, filters, 1, bias=False, weight_init=NORMAL)
        self.pointwise_bn = BatchNorm(filters, eps=epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.depth_activation:
            x = F.relu(x)
        x = self.depthwise_bn(self.depthwise(x))
        if self.depth_activation:
            x = F.relu(x)
        x = self.pointwise_bn(self.pointwise(x))
        if self.depth_activation:
            x = F.relu(x)
        return x


class UnetResBlock(nn.Module):
    """monai residual block (reference ``modules/unet.py:123-214``): conv1(k,s) → BN →
    lrelu(.01) → conv2(k,1) → BN, a 1×1+BN shortcut when the shape changes, add, lrelu.
    Convs drawn from a truncated normal, or a normal (``init_scheme='normal'``), of std 0.02."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 init_scheme: str = "trunc_normal"):
        super().__init__()
        init = TRUNC_NORMAL if init_scheme == "trunc_normal" else NORMAL
        self.conv1 = _MonaiConv(in_channels, out_channels, kernel_size, stride=stride,
                                padding=_unet_padding(kernel_size, stride), bias=False, weight_init=init)
        self.norm1 = BatchNorm(out_channels)
        self.conv2 = _MonaiConv(out_channels, out_channels, kernel_size, stride=1,
                                padding=_unet_padding(kernel_size, 1), bias=False, weight_init=init)
        self.norm2 = BatchNorm(out_channels)
        self.downsample = in_channels != out_channels or stride != 1
        if self.downsample:
            self.conv3 = _MonaiConv(in_channels, out_channels, 1, stride=stride, bias=False, weight_init=init)
            self.norm3 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        out = self.norm2(self.conv2(out))
        residual = self.norm3(self.conv3(x)) if self.downsample else x
        return F.leaky_relu(out + residual, 0.01)


class UnetOutBlock(nn.Module):
    """1×1 output conv with bias (reference ``modules/unet.py:357-381``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _MonaiConv(in_channels, out_channels, 1, bias=True, weight_init=TRUNC_NORMAL, bias_init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetBasicBlock(nn.Module):
    """Two conv + BN + lrelu(.01) stages, no residual (reference ``modules/unet.py:217-285``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv1 = _MonaiConv(in_channels, out_channels, kernel_size, stride=stride,
                                padding=_unet_padding(kernel_size, stride), bias=False, weight_init=TRUNC_NORMAL)
        self.norm1 = BatchNorm(out_channels)
        self.conv2 = _MonaiConv(out_channels, out_channels, kernel_size, stride=1,
                                padding=_unet_padding(kernel_size, 1), bias=False, weight_init=TRUNC_NORMAL)
        self.norm2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        return F.leaky_relu(self.norm2(self.conv2(x)), 0.01)


class UnetUpBlock(nn.Module):
    """Transposed-conv upsample, concat with the skip, UnetBasicBlock (reference
    ``modules/unet.py:288-354``); torch keys ``transp_conv``, ``conv_block``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, upsample_kernel_size: int = 2):
        super().__init__()
        k = upsample_kernel_size
        p = _unet_padding(k, k)
        self.transp_conv = ConvTranspose2d(in_channels, out_channels, k, stride=k, padding=p, output_padding=2 * p,
                                           bias=False, weight_init=TRUNC_NORMAL)
        self.conv_block = UnetBasicBlock(out_channels * 2, out_channels, kernel_size, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UpConv(nn.Module):
    """Bilinear ×2 (align_corners) + conv + BN + act (reference ``modules/blocks.py:206-221``);
    torch keys ``up.1`` (conv) and ``up.2`` (BN)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 activation: str = "relu"):
        super().__init__()
        self.act = get_act(activation)
        self.up = nn.Sequential(
            _Slot(),
            Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=kernel_size // 2, bias=False,
                   weight_init=NORMAL),
            BatchNorm(out_channels),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.resize_bilinear_by_scale(x, 2.0, align_corners=True)
        return self.act(self.up[2](self.up[1](x)))


class UpRb(nn.Module):
    """Bilinear ×2 (align_corners) + UnetResBlock with the normal init (reference
    ``modules/blocks.py:188-204``); torch key ``up.1``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.up = nn.Sequential(_Slot(), UnetResBlock(in_channels, out_channels, kernel_size, 1, init_scheme="normal"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up[1](F.resize_bilinear_by_scale(x, float(self.scale_factor), align_corners=True))


class UpTConv(nn.Module):
    """Transposed-conv upsample (reference ``modules/blocks.py:223-243``): stride 2,
    monai padding, ``output_padding`` 2p + s − k; torch key ``up.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 2):
        super().__init__()
        p = _unet_padding(kernel_size, stride)
        self.up = _MonaiConv(in_channels, out_channels, kernel_size, stride=stride, padding=p,
                             output_padding=2 * p + stride - kernel_size, bias=False, weight_init=NORMAL,
                             transposed=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class EUCB(nn.Module):
    """Efficient up-conv block (reference ``modules/blocks.py:297-321``): nearest ×2 →
    depthwise k → BN → act → channel_shuffle → pointwise 1×1 (bias)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 activation: str = "relu"):
        super().__init__()
        self.in_channels = in_channels
        self.act = get_act(activation)
        self.up_dwc = nn.Sequential(
            _Slot(),
            Conv2d(in_channels, in_channels, kernel_size, stride=stride, padding=kernel_size // 2,
                   groups=in_channels, bias=False, weight_init=NORMAL),
            BatchNorm(in_channels),
        )
        self.pwc = nn.Sequential(Conv2d(in_channels, out_channels, 1, bias=True, weight_init=NORMAL, bias_init="zeros"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.upsample_nearest(x, 2)
        x = self.act(self.up_dwc[2](self.up_dwc[1](x)))
        x = F.channel_shuffle(x, self.in_channels)
        return self.pwc[0](x)


class DownRb(nn.Module):
    """UnetResBlock with the normal init + 2×2 max pool (reference ``modules/blocks.py:261-279``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.rb = UnetResBlock(in_channels, out_channels, kernel_size, 1, init_scheme="normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.rb(x), 2, 2)


def make_up_block(kind: str, in_channels: int, out_channels: int, kernel_size: int = 3) -> nn.Module:
    """Up-block factory (reference ``decoders.py:53-62``, ``out.py:51-58``)."""
    if kind == "uprb":
        return UpRb(in_channels, out_channels, kernel_size, scale_factor=2)
    if kind == "eucb":
        return EUCB(in_channels, out_channels, kernel_size, stride=kernel_size // 2, activation="leakyrelu")
    if kind == "upcn":
        return UpConv(in_channels, out_channels, kernel_size, stride=1, activation="leakyrelu")
    if kind == "uptc":
        return UpTConv(in_channels, out_channels, kernel_size, stride=2)
    raise ValueError(f"Invalid up_block: {kind}")
