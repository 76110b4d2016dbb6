"""Functional spatial ops with exact PyTorch/scipy semantics, on NCHW tensors.

Mirrors ``cenet_tpu/nn/functional.py``. Every 1-D resampling operator is a dense
interpolation matrix built on the host in numpy and applied separably,
``out = W_h @ x @ W_wᵀ``, in the input's dtype, as the JAX package does. That
keeps the bf16 rounding the same in both (a torch ``F.interpolate`` would round
elsewhere) and reproduces scipy's spline prefilter exactly, since the zoom is
linear in its input.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF


# ---------------------------------------------------------------------------
# 1-D interpolation operator matrices (host-side numpy, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def torch_bilinear_matrix(
    in_size: int, out_size: int, align_corners: bool, scale: Optional[float] = None
) -> np.ndarray:
    """(out, in) matrix replicating torch ``F.interpolate`` linear sampling on one axis.

    torch (antialias=False) samples at ``src = o * (in-1)/(out-1)`` (align_corners)
    or ``max((o+0.5)/s - 0.5, 0)`` where ``s`` is the caller's scale_factor when one
    was given (recompute_scale_factor=False), else ``out/in``.
    """
    s = scale if scale is not None else out_size / in_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        if align_corners:
            src = 0.0 if out_size == 1 else o * (in_size - 1) / (out_size - 1)
        else:
            src = max((o + 0.5) / s - 0.5, 0.0)
        i0 = min(int(np.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        lam = src - i0
        w[o, i0] += 1.0 - lam
        w[o, i1] += lam
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def scipy_zoom_matrix(in_size: int, out_size: int, order: int) -> np.ndarray:
    """(out, in) matrix replicating 1-D ``scipy.ndimage.zoom(..., order=order)``,
    built by pushing the identity through scipy (prefilter included)."""
    from scipy.ndimage import zoom as _zoom

    eye = np.eye(in_size, dtype=np.float64)
    cols = _zoom(eye, (1.0, out_size / in_size), order=order)
    if cols.shape != (in_size, out_size):
        raise ValueError(f"scipy zoom gave {cols.shape}, expected {(in_size, out_size)}")
    return np.ascontiguousarray(cols.T).astype(np.float32)


@functools.lru_cache(maxsize=None)
def adaptive_avg_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging matrix for torch ``AdaptiveAvgPool1d`` bucket semantics."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        start = (o * in_size) // out_size
        end = -((-(o + 1) * in_size) // out_size)  # ceil
        w[o, start:end] = 1.0 / (end - start)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def zoom_nearest_indices(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Output→input index map (and validity) of 1-D scipy zoom with order=0,
    read off the identity push-through so scipy's boundary behaviour is exact."""
    m = scipy_zoom_matrix(in_size, out_size, order=0)
    idx = np.argmax(m, axis=1).astype(np.int64)
    valid = m.sum(axis=1) > 0
    return idx, valid


# ---------------------------------------------------------------------------
# Separable application (NCHW)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _matrix_on(key: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    kind, args = key[0], key[1:]
    m = {"bilinear": torch_bilinear_matrix, "zoom": scipy_zoom_matrix, "pool": adaptive_avg_pool_matrix}[kind](*args)
    # a normal tensor even when first asked for under inference_mode, so that a
    # later training step can save it for its backward
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device=device, dtype=dtype)


def _apply_separable(x: torch.Tensor, kh: tuple, kw: tuple) -> torch.Tensor:
    """Contract H with W_h, then W with W_w (the JAX package's order), in x's dtype."""
    wh = _matrix_on(kh, x.device, x.dtype)
    ww = _matrix_on(kw, x.device, x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.t())


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(x, size=out_hw, mode='bilinear', align_corners=...)``."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    return _apply_separable(x, ("bilinear", h, oh, align_corners, None), ("bilinear", w, ow, align_corners, None))


def resize_bilinear_by_scale(x: torch.Tensor, scale: float, align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(x, scale_factor=scale, mode='bilinear')``: out = floor(in*s),
    with the given scale (not out/in) in the coordinate mapping."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(h * scale), int(w * scale)
    if (oh, ow) == (h, w) and align_corners:
        return x
    return _apply_separable(
        x, ("bilinear", h, oh, align_corners, scale), ("bilinear", w, ow, align_corners, scale)
    )


def zoom_resize(x: torch.Tensor, out_hw: tuple[int, int], order: int = 3) -> torch.Tensor:
    """``scipy.ndimage.zoom`` to ``out_hw`` with spline ``order``, batched on device."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    return _apply_separable(x, ("zoom", h, oh, order), ("zoom", w, ow, order))


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d(out_hw)``, as the JAX package's matrix product."""
    h, w = x.shape[2], x.shape[3]
    return _apply_separable(x, ("pool", h, out_hw[0]), ("pool", w, out_hw[1]))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """torch ``nn.Upsample(scale_factor=f)`` (nearest)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def max_pool2d(x: torch.Tensor, kernel: int = 2, stride: int = 2) -> torch.Tensor:
    """torch ``MaxPool2d(kernel, stride)`` (no padding)."""
    return tF.max_pool2d(x, kernel, stride)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Reference channel shuffle (``modules/blocks.py:285-294``)."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


# ---------------------------------------------------------------------------
# Activations with exact torch semantics
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32; the tanh approximation under bf16, as the JAX
    package switches (its deviation from erf-GELU is below bf16 resolution)."""
    if x.dtype == torch.bfloat16:
        return tF.gelu(x, approximate="tanh")
    return tF.gelu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return tF.leaky_relu(x, negative_slope)


def silu(x: torch.Tensor) -> torch.Tensor:
    return tF.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return tF.relu(x)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return tF.hardswish(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return tF.relu6(x)


def softmax_fp32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax computed in float32 and cast back (reference ``multihead_diffattn.py:108``)."""
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


def round_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host.

    The JAX package multiplies by scalars cast to the activation dtype first
    (``jnp.asarray(scale, q.dtype)``); multiplying by the rounded Python float
    gives the same product without a device tensor."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype).float())
