"""Core layers with the JAX package's numerics, as NCHW ``nn.Module``s.

Mirrors ``cenet_tpu/nn/layers.py``. Parameters live in fp32 under the reference
torch names (``weight``, ``bias``, ``running_mean``, ``running_var``); compute
runs in the input's dtype, with weights cast at use, except for the fp32
islands the JAX package keeps: normalisation statistics (BatchNorm, LayerNorm,
RMSNorm). Initialisation follows torch defaults: weights are meant to be
carried over (``cenet_tpu_torch/convert``) or loaded from a reference ``.pth``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as tF

from cenet_tpu_torch.nn import functional as F


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """torch ``nn.Conv2d`` whose fp32 weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Linear(nn.Linear):
    """torch ``nn.Linear`` (the JAX package's ``Dense``), cast at use like :class:`Conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tF.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class BatchNorm(nn.Module):
    """torch BatchNorm (1d/2d) over dim 1 with fp32 statistics.

    Eval normalises with the running statistics. Train normalises with the
    biased batch variance and updates the running statistics with the unbiased
    one, torch's ``momentum=0.1`` convention. ``num_batches_tracked`` is kept so
    that reference ``.pth`` files load strictly; nothing reads it.
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
            mean = xf.mean(dim=axes)
            var = (xf * xf).mean(dim=axes) - mean * mean
            n = xf.numel() // xf.shape[1]
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var * (n / max(n - 1, 1)))
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


class _RandomMask(nn.Module):
    """Shared body of :class:`DropPath` and :class:`Dropout`: in train mode with
    a rate above 0, ``where(mask, x / keep, 0)`` in x's dtype for a Bernoulli(keep)
    mask of :meth:`mask_shape`, drawn from ``self.generator`` (a
    ``torch.Generator`` on x's device that the trainer attaches; never the
    global RNG). The identity in eval mode or at rate 0."""

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
        mask = torch.rand(self.mask_shape(x), generator=self.generator, device=x.device) < keep
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
