"""Core layers with the JAX package's numerics, as NCHW ``nn.Module``s.

Mirrors ``cenet_tpu/nn/layers.py``. Parameters live in fp32 under the reference
torch names (``weight``, ``bias``, ``running_mean``, ``running_var``); compute
runs in the input's dtype, with weights cast at use, except for the fp32
islands the JAX package keeps: normalisation statistics (BatchNorm, LayerNorm,
RMSNorm, GroupNorm).

Initial weights follow the JAX package's initializers (``layers.py:38-96``).
:class:`Conv2d`, :class:`ConvTranspose2d` and :class:`Linear` take the
distribution of their weight and bias by name (``weight_init``,
``bias_init``; :func:`draw_`), as the JAX layers take ``weight_init`` and
``bias_init``, and draw it in ``reset_parameters(generator)``. Without a name
they take the JAX layers' default, torch's U(±1/√fan_in).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as tF

from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.nn import functional as F


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


# An initial distribution by name: "torch" (U(±1/√fan_in), the JAX layers'
# default), "fan_out" (N(0, 2/fan_out), fan_out = kh·kw·O/groups: the reference's
# PVT and ResNet conv init), "zeros", ("normal", std) or ("trunc_normal", std)
# (JAX's truncated_normal: std times a standard normal cut at ±2, so its
# standard deviation is 0.88·std).
Init = Union[str, Tuple[str, float]]
NORMAL = ("normal", 0.02)
TRUNC_NORMAL = ("trunc_normal", 0.02)


def draw_(t: torch.Tensor, init: Init, fan_in: int, fan_out: int, generator: Optional[torch.Generator]) -> None:
    """Fill ``t`` in place from the distribution ``init`` names, from ``generator``."""
    kind, std = (init, None) if isinstance(init, str) else init
    with torch.no_grad():
        if kind == "torch":
            bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
            t.uniform_(-bound, bound, generator=generator)
        elif kind == "fan_out":
            t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif kind == "normal":
            t.normal_(0.0, std, generator=generator)
        elif kind == "trunc_normal":
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std)
        elif kind == "zeros":
            t.zero_()
        else:
            raise ValueError(f"unknown initializer {init!r}")


class Conv2d(nn.Conv2d):
    """torch ``nn.Conv2d`` whose fp32 weight and bias are cast to the input's dtype,
    drawn from ``weight_init`` and ``bias_init``."""

    def __init__(self, *args, weight_init: Init = "torch", bias_init: Init = "torch", **kw):
        self.weight_init, self.bias_init = weight_init, bias_init
        super().__init__(*args, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kh, kw = self.kernel_size
        fan_in = self.in_channels // self.groups * kh * kw
        draw_(self.weight, self.weight_init, fan_in, kh * kw * self.out_channels // self.groups, generator)
        if self.bias is not None:
            draw_(self.bias, self.bias_init, fan_in, 0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ``nn.ConvTranspose2d`` (``output_padding`` included), weight (I, O, kh, kw),
    cast at use like :class:`Conv2d`. Its default weight init takes the JAX layer's
    fan_in, kh·kw·I (``cenet_tpu/nn/layers.py:199``), and its bias kh·kw·O, torch's."""

    def __init__(self, *args, weight_init: Init = "torch", **kw):
        self.weight_init = weight_init
        super().__init__(*args, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kh, kw = self.kernel_size
        draw_(self.weight, self.weight_init, kh * kw * self.in_channels, kh * kw * self.out_channels, generator)
        if self.bias is not None:
            draw_(self.bias, "torch", kh * kw * self.out_channels, 0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tF.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride, self.padding,
                                   self.output_padding, self.groups, self.dilation)


class Conv1d(nn.Conv1d):
    """torch ``nn.Conv1d`` with torch's default init drawn from a generator (the
    CCU's grouped weights; ``cenet_tpu/nn/cfam.py::_conv1d_init``)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.in_channels // self.groups * self.kernel_size[0]
        draw_(self.weight, "torch", fan_in, 0, generator)
        if self.bias is not None:
            draw_(self.bias, "torch", fan_in, 0, generator)


class Linear(nn.Linear):
    """torch ``nn.Linear`` (the JAX package's ``Dense``), cast at use like
    :class:`Conv2d`, drawn from ``weight_init`` and ``bias_init``."""

    def __init__(self, *args, weight_init: Init = "torch", bias_init: Init = "torch", **kw):
        self.weight_init, self.bias_init = weight_init, bias_init
        super().__init__(*args, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        draw_(self.weight, self.weight_init, self.in_features, self.out_features, generator)
        if self.bias is not None:
            draw_(self.bias, self.bias_init, self.in_features, 0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tF.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class BatchNorm(nn.Module):
    """torch BatchNorm (1d/2d) over dim 1 with fp32 statistics.

    Eval normalises with the running statistics. Train normalises with the
    biased batch variance and updates the running statistics with the unbiased
    one, torch's ``momentum=0.1`` convention. ``num_batches_tracked`` is kept so
    that reference ``.pth`` files load strictly; nothing reads it.

    Under a registered mesh (``core/mesh.py``) train mode takes the statistics
    of the global batch, as GSPMD's mean does in the JAX step: the per-channel
    sum, sum of squares and count are all-reduced in fp32 over the data group
    (the backward all-reduces their gradients), and the mean, E[x²] and the
    running statistics, n/(n−1) included, come from the global values.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = [1, -1] + [1] * (x.ndim - 2)
        if self.training:
            axes = [0] + list(range(2, x.ndim))
            group = M.data_group()
            if group is None:
                mean = xf.mean(dim=axes)
                var = (xf * xf).mean(dim=axes) - mean * mean
                n = xf.numel() // xf.shape[1]
            else:
                c = x.shape[1]
                sums = torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                                  xf.new_full((1,), float(xf.numel() // c))])
                sums = M.all_reduce_sum(sums, group)
                n = sums[2 * c]
                mean = sums[:c] / n
                var = sums[c : 2 * c] / n - mean * mean
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                unbias = n / max(n - 1, 1) if isinstance(n, int) else n / (n - 1).clamp(min=1)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var * unbias)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """torch ``nn.LayerNorm`` over the last dim with fp32 statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class RMSNorm(nn.Module):
    """fp32 RMSNorm over the last dim (reference ``modules/rms_norm.py:15-22``);
    ``affine=False`` is the diff-attention ``subln``, which has no parameters."""

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            y = y * self.weight
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """torch ``nn.GroupNorm`` over dim 1 with fp32 statistics (``cenet_tpu/nn/layers.py::GroupNorm``)."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.float().reshape(b, self.num_groups, -1)
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = [1, -1] + [1] * (x.ndim - 2)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """The reference's channels-first LayerNorm2d (``modules/cfam.py:57-83``): a
    LayerNorm over dim 1 of NCHW maps (the JAX package's LayerNorm on NHWC)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class _RandomMask(nn.Module):
    """Shared body of :class:`DropPath` and :class:`Dropout`: in train mode with
    a rate above 0, ``where(mask, x / keep, 0)`` in x's dtype for a Bernoulli(keep)
    mask of :meth:`mask_shape`, drawn from ``self.generator`` (a
    ``torch.Generator`` on x's device that the trainer attaches; never the
    global RNG). The identity in eval mode or at rate 0. Under a registered
    mesh with a data axis the mask of the global batch is drawn (dim 0 holds
    the batch) and the rank's rows are taken: every rank draws what the one
    process draws, so the generators stay in step and each sample gets its
    own mask."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor) -> tuple:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__} in train mode needs a generator (see set_generator)")
        keep = 1.0 - self.rate
        shape = self.mask_shape(x)
        mesh = M.get_attention_mesh()
        if mesh is None or mesh.data == 1:
            mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        else:
            b = shape[0]
            full = torch.rand((M.global_batch(b),) + tuple(shape[1:]), generator=self.generator, device=x.device)
            mask = full[mesh.d * b : (mesh.d + 1) * b] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(_RandomMask):
    """Per-sample stochastic depth (timm semantics: scale by 1/keep), as
    ``cenet_tpu/nn/layers.py::DropPath``: one draw per sample."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return (x.shape[0],) + (1,) * (x.ndim - 1)


class Dropout(_RandomMask):
    """Element dropout, as ``cenet_tpu/nn/layers.py::Dropout``: one draw per element."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape)


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Attach ``generator`` to every :class:`DropPath` and :class:`Dropout` of ``model``."""
    for mod in model.modules():
        if isinstance(mod, _RandomMask):
            mod.generator = generator


def get_act(name: Optional[str], neg_slope: float = 0.2) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation factory mirroring the reference ``act_layer`` (``modules/blocks.py:76-93``)."""
    if name is None:
        return lambda x: x
    name = name.lower()
    if name == "relu":
        return F.relu
    if name == "relu6":
        return F.relu6
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, neg_slope)
    if name == "gelu":
        return F.gelu
    if name == "silu":
        return F.silu
    if name == "hswish":
        return F.hardswish
    if name == "sigmoid":
        return torch.sigmoid
    raise NotImplementedError(f"activation layer [{name}] is not found")
