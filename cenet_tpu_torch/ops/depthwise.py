"""Depthwise 3×3 convolution with CUDA kernels (K11), plain twins and an autograd Function.

Mirrors ``tools/negative_results/depthwise.py``: :func:`depthwise_conv3x3` is
``depthwise_conv3x3`` there, stride 1, padding = dilation, NHWC x and HWIO
weights ``(3, 3, 1, C)``. Its kernels replace ``_pallas_depthwise_fwd`` and
``_pallas_depthwise_dw`` (source ``csrc/depthwise_conv.cu``, which also plans
the dw kernel's cut: which kernel by layout, how many parts to sum in order;
:func:`dw_plan` asks it); ``DW_ROUTES`` counts the routes the dw wrapper's
launches took.
:class:`DepthwiseConvFn` is ``_depthwise_pallas``'s custom_vjp: dx is the
forward kernel on the upstream gradient with the spatially flipped kernel,
dw the dw kernel (fp32, cast to w's dtype).

Domain. The JAX router takes the Pallas kernel on a TPU when the padded map
fits VMEM and H, W ≥ 2. VMEM is TPU memory; on the card every CUDA tensor with
H, W ≥ 2 and a dilation of 1–5 (the forward kernel's instances; the model
uses 1–5) takes the kernels, and other shapes are ``F.conv2d`` (the
counterpart of ``_lax_depthwise``, a shape rule, not a fallback). The JAX router's
``try``/``except`` is not carried over: a CUDA tensor in the domain reaches
the kernel or raises. A CPU tensor takes the twins.

Layout. The kernels read x, g and write the output through element strides
on every dim, so an NCHW tensor arrives as its ``permute(0, 2, 3, 1)`` view
and a ``(C, 1, 3, 3)`` weight as ``permute(2, 3, 1, 0)``, with no copy; the
output keeps x's memory order (``empty_like``), so an NCHW caller gets an NCHW
tensor back through ``permute(0, 3, 1, 2)``.

No configuration of either package routes this kernel;
``chip_smoke.py::swapped_ops`` puts it at the model's depthwise sites.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as tF

from cenet_tpu_torch.ops import binding

_FWD_ARGTYPES = [binding.I] + [binding.P] * 3 + [binding.I] * 5 + [binding.L] * 8 + [binding.P]
_DW_ARGTYPES = [binding.I] + [binding.P] * 5 + [binding.I] * 5 + [binding.L] * 8 + [binding.P]
_PLAN_ARGTYPES = [binding.I] * 6 + [binding.L] * 2 + [binding.P]
DILATIONS = range(1, 6)  # csrc/depthwise_conv.cu: the forward's instances
DW_ROUTE_NAMES = ("channels_last", "planes")  # csrc/depthwise_conv.cu: DwRoute, in order
DW_ROUTES = collections.Counter()  # dw launches by route


def _taps(w: torch.Tensor) -> torch.Tensor:
    """``(3, 3, 1, C)`` or ``(3, 3, C)`` weights as ``(3, 3, C)``."""
    return w.reshape(3, 3, w.shape[-1])


def _shifted(x: torch.Tensor, dilation: int):
    """The nine zero-padded shifts of NHWC x, in (dy, dx) order."""
    r = dilation
    h, wd = x.shape[1], x.shape[2]
    xp = tF.pad(x, (0, 0, r, r, r, r))
    return [xp[:, dy * r:dy * r + h, dx * r:dx * r + wd] for dy in range(3) for dx in range(3)]


def depthwise_fwd_plain(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """``_fwd_kernel``: Σ over the taps of shift(x) times the fp32 tap, in fp32,
    one cast to x's dtype."""
    taps = _taps(w).float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t, xs in enumerate(_shifted(x, dilation)):
        acc = acc + xs.float() * taps[t // 3, t % 3]
    return acc.to(x.dtype)


def depthwise_dw_plain(x: torch.Tensor, g: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """``_dw_kernel`` over the batch: dw[dy, dx, c] = Σ over batch and map of
    shift(x)·g in fp32, ``(3, 3, C)``."""
    gf = g.float()
    dw = torch.stack([(xs.float() * gf).sum(dim=(0, 1, 2)) for xs in _shifted(x, dilation)])
    return dw.reshape(3, 3, x.shape[-1])


def _check(name: str, x: torch.Tensor, other: torch.Tensor, oname: str) -> None:
    binding.check_cuda_dtype(name, {"x": x, oname: other}, x.dtype)
    if x.ndim != 4 or tuple(other.shape) != tuple(x.shape):
        raise ValueError(f"{name}: x {tuple(x.shape)} and {oname} {tuple(other.shape)} must be one NHWC shape")


def depthwise_fwd(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """The forward kernel: NHWC x (any strides), weights ``(3, 3, [1,] C)``.
    Returns the output in x's dtype and memory order."""
    if x.device.type == "cpu":
        return depthwise_fwd_plain(x, w, dilation)
    name = "depthwise_fwd"
    binding.check_cuda_dtype(name, {"x": x}, x.dtype)
    c = x.shape[-1]
    if x.ndim != 4 or w.numel() != 9 * c or not w.is_cuda or dilation not in DILATIONS:
        raise ValueError(f"{name}: x {tuple(x.shape)} with weights {tuple(w.shape)} on {w.device}, "
                         f"dilation {dilation}")
    taps = _taps(w).float().contiguous()
    out = torch.empty_like(x)
    if max(binding.last_offset(x), binding.last_offset(out)) >= 2**31:
        raise ValueError(f"{name}: x {tuple(x.shape)} strides {x.stride()} pass 32-bit element offsets")
    b, h, wd, _ = x.shape
    rc = binding.kernel("depthwise_conv", "cenet_depthwise_fwd", _FWD_ARGTYPES)(
        binding.is_bf16(x), *binding.ptrs(x, taps, out), b, h, wd, c, dilation, *binding.strides(x, 4),
        *binding.strides(out, 4), binding.stream())
    binding.raise_on(name, rc)
    binding.LAUNCHES[name] += 1
    return out


def dw_plan(x: torch.Tensor, g: torch.Tensor, dilation: int):
    """The dw kernel's route ("channels_last" when x and g both have a unit
    channel stride, else "planes"), its blocks along C (``groups``) and its
    ``parts`` (slices of the positions, each giving one partial of every (tap,
    channel), added in part order), as ``csrc/depthwise_conv.cu::dw_plan``
    cuts NHWC x and g: ``(route, groups, parts)``."""
    b, h, wd, c = x.shape
    out = (ctypes.c_int * 3)()
    rc = binding.kernel("depthwise_conv", "cenet_depthwise_dw_plan", _PLAN_ARGTYPES)(
        binding.is_bf16(x), b, h, wd, c, dilation, x.stride(3), g.stride(3), out)
    if rc != 0:
        raise ValueError(f"depthwise_dw: no cut of x {tuple(x.shape)} at dilation {dilation} fits the kernels: "
                         f"a row of width {wd} with its halo is wider than a block's shared memory")
    return DW_ROUTE_NAMES[out[0]], out[1], out[2]


_TICKETS = {}  # (device, stream): the ordered sum's counters, left zeroed by every launch


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def depthwise_dw(x: torch.Tensor, g: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """The dw kernel: Σ over batch and map of shift(x)·g, ``(3, 3, C)`` fp32, by
    the route and cut of :func:`dw_plan`, its partials added in order in the
    same launch (no atomics on the sums: repeat runs are bit-identical)."""
    if x.device.type == "cpu":
        return depthwise_dw_plain(x, g, dilation)
    name = "depthwise_dw"
    _check(name, x, g, "g")
    if dilation not in DILATIONS:
        raise ValueError(f"{name}: dilation {dilation}")
    if max(binding.last_offset(x), binding.last_offset(g), x.numel()) >= 2**31:
        raise ValueError(f"{name}: x {tuple(x.shape)} strides {x.stride()}, g {g.stride()} pass 32-bit offsets")
    b, h, wd, c = x.shape
    route, groups, parts = dw_plan(x, g, dilation)
    dw = torch.empty((3, 3, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((parts, 9, c), dtype=torch.float32, device=x.device) if parts > 1 else dw
    stream = binding.stream()
    tickets = _tickets(x.device, stream, groups)
    rc = binding.kernel("depthwise_conv", "cenet_depthwise_dw", _DW_ARGTYPES)(
        binding.is_bf16(x), *binding.ptrs(x, g, partial, dw, tickets), b, h, wd, c, dilation,
        *x.stride(), *g.stride(), stream)
    binding.raise_on(name, rc)
    binding.LAUNCHES[name] += 1
    DW_ROUTES[route] += 1
    return dw


class DepthwiseConvFn(torch.autograd.Function):
    """:func:`depthwise_fwd` with ``_dp_bwd``'s backward: dx = :func:`depthwise_fwd`
    on g with the flipped kernel, dw = :func:`depthwise_dw` cast to w's dtype."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return depthwise_fwd(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = depthwise_fwd(g, _taps(w).flip(0, 1), ctx.dilation) if ctx.needs_input_grad[0] else None
        dw = depthwise_dw(x, g, ctx.dilation).reshape(w.shape).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Depthwise 3×3, stride 1, padding = dilation, NHWC x, HWIO ``(3, 3, 1, C)``
    weights: the kernels for H, W ≥ 2 and dilations 1–5 (through
    :class:`DepthwiseConvFn` when autograd records), ``F.conv2d`` otherwise."""
    h, wd, c = x.shape[1], x.shape[2], x.shape[3]
    if h < 2 or wd < 2 or dilation not in DILATIONS:
        y = tF.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=dilation,
                      dilation=dilation, groups=c)
        return y.permute(0, 2, 3, 1)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DepthwiseConvFn.apply(x, w, dilation)
    return depthwise_fwd(x, w, dilation)
