"""RMSNorm with a CUDA forward kernel (K9), its plain twin and its autograd Function.

Mirrors ``cenet_tpu/ops/rms_norm.py``: :func:`rms_norm` is ``rms_norm`` there,
x·rsqrt(mean(x²) + eps), times ``weight`` if one is given, over the last dim,
with fp32 statistics and the output in x's dtype. Its kernel replaces
``_rms_fwd_impl`` (the Pallas bodies ``_rms_kernel`` and ``_rms_weight_kernel``),
source ``csrc/rms_norm.cu``. :class:`RMSNormFn` pairs it with the backward of
``_rms_bwd``, which the JAX package leaves to XLA: plain PyTorch in fp32 here,
no kernel.

A CPU tensor takes :func:`rms_norm_plain`; a CUDA tensor launches the kernel
(built at first use) or raises. No configuration of either package routes this
kernel; ``chip_smoke.py::swapped_ops`` puts it at the DSEB ``subln`` sites.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cenet_tpu_torch.ops import binding

_ARGTYPES = [binding.I, binding.P, binding.P, binding.P, binding.L, binding.I, ctypes.c_float, binding.P]


def rms_norm_plain(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """``_xla_rms``: fp32 statistics and product, one cast to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, weight: Optional[torch.Tensor], g: torch.Tensor, eps: float = 1e-5):
    """``_rms_bwd`` in fp32: dx = g·inv − x·inv³·Σ(g·x)/D (g times w first when a
    weight is given), dw = Σ over rows of g·x·inv. Returns ``(dx, dw or None)``
    in the dtypes of x and w."""
    xf, gf = x.float(), g.float()
    d = x.shape[-1]
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = None
    if weight is not None:
        gw = (gf * xf * inv).reshape(-1, d).sum(dim=0).to(weight.dtype)
        gf = gf * weight.float()
    dot = (gf * xf).sum(dim=-1, keepdim=True)
    dx = (gf * inv - xf * inv**3 * dot / d).to(x.dtype)
    return dx, gw


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x`` (any shape (…, D)) over its last dim; ``weight`` (D,) or None.
    On the card: K9 on x as rows × D (a copy first if x is not contiguous), the
    weight read in fp32."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    name = "rms_norm"
    binding.check_cuda_dtype(name, {"x": x}, x.dtype)
    d = x.shape[-1]
    w = None
    if weight is not None:
        if tuple(weight.shape) != (d,) or not weight.is_cuda:
            raise ValueError(f"{name}: weight {tuple(weight.shape)} on {weight.device} does not fit x {tuple(x.shape)}")
        w = weight.float().contiguous()
    xc = x.contiguous()
    y = torch.empty_like(xc)
    rc = binding.kernel("rms_norm", "cenet_rms_norm", _ARGTYPES)(
        binding.is_bf16(x), xc.data_ptr(), None if w is None else w.data_ptr(), y.data_ptr(), xc.numel() // d, d,
        float(eps), binding.stream())
    binding.raise_on(name, rc)
    binding.LAUNCHES[name] += 1
    return y


class RMSNormFn(torch.autograd.Function):
    """:func:`rms_norm` (K9 on the card) with the backward of ``_rms_bwd`` in
    plain fp32 PyTorch, as ``rms_norm``'s custom_vjp in the JAX package."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd_plain(x, weight, g, ctx.eps)
        return dx, dw, None
