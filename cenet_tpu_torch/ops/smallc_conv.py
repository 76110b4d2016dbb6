"""Small-channel K×K convolution with CUDA kernels (K12), plain twins and an autograd Function.

Mirrors ``tools/negative_results/smallc_conv.py``: :func:`conv_small_c` is
``conv_small_c`` there (stride 1, NHWC x, HWIO weights ``(k, k, Cin, Cout)``,
padding k//2). Its kernels replace ``_pallas_conv_fwd`` and
``_pallas_conv_bwd`` (source ``csrc/smallc_conv.cu``): for the forward an
implicit GEMM on the tensor cores in bf16 (``mma.sync``, fp32 sums) and a
direct convolution on CUDA cores in fp32, which the tensor cores take only as
TF32; for the backward in bf16 dx on the forward's tensor-core kernel and dw
as an implicit GEMM on the tensor cores (both reading channels-last copies of
x and g that the source's transpose kernel makes in wrapper-allocated scratch
where the inputs are NCHW views), in fp32 one fused launch for dx and dw on
CUDA cores, then the ordered sum of the dw partials. :class:`ConvSmallCFn` is
``_conv_small_c_pallas``'s custom_vjp.

Domain: the conditions of ``conv_small_c``'s ``ok`` that define the function
(:func:`in_domain`): stride 1, a square odd kernel of size 3–7, padding
k//2, Cin ∈ {8, 16, 32, 64}, Cout % 8 == 0 and Cout ≤ 256, H·W ≥ 112² and
H, W ≥ k. Dropped, since they describe TPU memory or its (8, 128) tiling:
``vmem_need`` ≤ 80 MB, ``_row_block(h) % 8 == 0`` and W % 8 == 0. Outside the
domain the function is ``F.conv2d``, the counterpart of ``_lax_conv`` (a
convolution the JAX package computes outside any Pallas kernel): a shape rule,
not a fallback. The JAX router's ``try``/``except`` is not carried over: a CUDA
tensor in the domain reaches the kernel or raises. A CPU tensor takes the twins.

Layout: the kernels read x and g and write their outputs through element
strides on every dim, so NCHW tensors arrive as ``permute(0, 2, 3, 1)`` views
and ``(Cout, Cin, k, k)`` weights as ``permute(2, 3, 1, 0)``; the outputs keep
x's memory order (channels-last if x is, else NCHW memory behind an NHWC view).

No configuration of either package routes this kernel;
``chip_smoke.py::swapped_ops`` puts it at the OutHead convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from cenet_tpu_torch.ops import binding

_FWD_ARGTYPES = [binding.I] + [binding.P] * 3 + [binding.I] * 6 + [binding.L] * 8 + [binding.P]
_BWD_ARGTYPES = [binding.I] + [binding.P] * 8 + [binding.I] * 6 + [binding.L] * 12 + [binding.I, binding.P]
_CINS = (8, 16, 32, 64)
# csrc/smallc_conv.cu: the CUDA-core dw blocks' tile (8 x 16 pixels), channels
# per block; the tensor-core dw blocks' pixel tile and m blocks (16 rows (tap,
# ci) of dW) per block at 32 and 64 output channels a block (ConvDwTiles)
_DW_TH, _DW_TW, _DW_CI, _CO_T = 8, 16, 8, 32
_TC_DW_TH, _TC_DW_MBLOCKS = 8, {32: 16, 64: 8}
_TARGET_DW_BLOCKS = 4 * 132  # about four CUDA-core dw blocks per SM of an H100
_TARGET_TC_DW_BLOCKS = 2 * 132  # about two tensor-core dw blocks per SM


def in_domain(x_shape, w_shape, padding: int, stride: int = 1) -> bool:
    """Whether ``conv_small_c`` computes on the kernels (shapes NHWC and HWIO).

    Inside it, a bf16 backward takes dx on the tensor cores where Cout is one of
    the forward kernel's contraction widths (8, 16, 32, 64) and on the CUDA-core
    dx blocks for any other Cout (:func:`dx_on_tensor_cores`), a shape rule."""
    _, h, wd, cin = x_shape
    kh, kw, wcin, cout = w_shape
    return (stride == 1 and kh == kw and kh % 2 == 1 and 3 <= kh <= 7 and padding == kh // 2 and wcin == cin
            and cin in _CINS and cout % 8 == 0 and cout <= 256 and h * wd >= 112 * 112 and h >= kh and wd >= kh)


def _shifts(x: torch.Tensor, k: int, p: int):
    """((dy, dx), shift) for every tap: x shifted as the SAME conv reads it."""
    h, wd = x.shape[1], x.shape[2]
    xp = tF.pad(x, (0, 0, p, p, p, p))
    return [((dy, dx), xp[:, dy:dy + h, dx:dx + wd]) for dy in range(k) for dx in range(k)]


def conv_small_c_plain(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """Σ over the taps of shift(x)·W[tap]: x and w (rounded to x's dtype, as the
    JAX wrapper packs it) in fp32 products and sums, one cast to x's dtype."""
    wf = w.to(x.dtype).float()
    acc = None
    for (dy, dx), xs in _shifts(x, w.shape[0], padding):
        term = torch.matmul(xs.float(), wf[dy, dx])
        acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def conv_small_c_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, padding: int):
    """``_pallas_conv_bwd``: dx = Σ over the taps of shift(g)·W'[tap] with W' the
    weights flipped in space and in/out swapped (g and W' in x's dtype, fp32
    sums, cast to x's dtype); dw[tap] = shift(x)ᵀ·g summed over batch and map
    in fp32, cast to w's dtype. Returns ``(dx, dw)``."""
    g = g.to(x.dtype)
    wflip = w.flip(0, 1).transpose(2, 3)
    dx = conv_small_c_plain(g, wflip, padding)
    gf = g.float().reshape(-1, g.shape[-1])
    k = w.shape[0]
    dw = torch.stack([xs.float().reshape(-1, x.shape[-1]).t() @ gf for _, xs in _shifts(x, k, padding)])
    return dx, dw.reshape(w.shape).to(w.dtype)


def _out_like(x: torch.Tensor, channels: int) -> torch.Tensor:
    """An NHWC tensor of ``channels`` in x's memory order (channels-last or NCHW)."""
    b, h, wd, _ = x.shape
    if x.stride(3) == 1:
        return torch.empty((b, h, wd, channels), dtype=x.dtype, device=x.device)
    return torch.empty((b, channels, h, wd), dtype=x.dtype, device=x.device).permute(0, 2, 3, 1)


def _channels_last_aligned(t: torch.Tensor) -> bool:
    """Channels-last with 16-byte aligned pixels, as the bf16 backward's
    tensor-core kernels read x and g (csrc/smallc_conv.cu: vec_in)."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


def _check(name: str, x: torch.Tensor, w: torch.Tensor, padding: int) -> None:
    binding.check_cuda_dtype(name, {"x": x}, x.dtype)
    if x.ndim != 4 or w.ndim != 4 or not w.is_cuda or not in_domain(tuple(x.shape), tuple(w.shape), padding):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} on {w.device}, padding {padding} "
                         "are outside the kernel's domain")


def conv_small_c_fwd(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """The forward kernel: NHWC x (any strides), HWIO w, inside :func:`in_domain`."""
    if x.device.type == "cpu":
        return conv_small_c_plain(x, w, padding)
    name = "conv_small_c_fwd"
    _check(name, x, w, padding)
    b, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    # rounded to x's dtype and stored in it (the tensor-core kernel's 16-byte
    # weight rows need an aligned start)
    wk = w.to(x.dtype).contiguous()
    if wk.data_ptr() % 16:
        wk = wk.clone()
    out = _out_like(x, cout)
    rc = binding.kernel("smallc_conv", "cenet_smallc_conv_fwd", _FWD_ARGTYPES)(
        binding.is_bf16(x), *binding.ptrs(x, wk, out), b, h, wd, cin, cout, k, *binding.strides(x, 4),
        *binding.strides(out, 4), binding.stream())
    binding.raise_on(name, rc)
    binding.LAUNCHES[name] += 1
    return out


def dx_on_tensor_cores(dtype: torch.dtype, cout: int) -> bool:
    """Whether the backward's dx runs on the tensor-core forward (bf16, Cout one
    of its contraction widths); csrc/smallc_conv.cu applies the same rule."""
    return dtype == torch.bfloat16 and cout in _CINS


def bwd_parts(x_shape, k: int, cout: int, dtype: torch.dtype = torch.float32) -> int:
    """How many slices of the pixel tiles the dw blocks cut (one partial each),
    enough blocks to fill the card: the CUDA-core dw blocks (fp32) or the
    tensor-core ones (bf16), each part taking every slice of dW's rows."""
    b, h, wd, cin = x_shape
    if dtype == torch.bfloat16:
        nt = 32 if cout <= 32 else 64
        m_blocks = -(-k * k * cin // 16)
        per_part = -(-m_blocks // _TC_DW_MBLOCKS[nt]) * -(-cout // nt)
        tiles, target = b * -(-h // _TC_DW_TH) * -(-wd // 16), _TARGET_TC_DW_BLOCKS
    else:
        per_part = -(-cout // _CO_T) * (cin // _DW_CI)
        tiles, target = b * -(-h // _DW_TH) * -(-wd // _DW_TW), _TARGET_DW_BLOCKS
    return max(1, min(tiles, -(-target // per_part)))


def conv_small_c_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, padding: int):
    """The backward kernels: ``(dx, dw)`` for upstream gradient ``g`` (NHWC, any
    strides); dx in x's dtype and memory order, dw in w's dtype, summed in fp32
    without atomics (repeat runs are bit-identical). One count per call, for the
    dx, dw and partial-sum launches together."""
    if x.device.type == "cpu":
        return conv_small_c_bwd_plain(x, w, g, padding)
    name = "conv_small_c_bwd"
    _check(name, x, w, padding)
    g = g.to(x.dtype)
    b, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    if tuple(g.shape) != (b, h, wd, cout):
        raise ValueError(f"{name}: g {tuple(g.shape)} does not fit x {tuple(x.shape)} and w {tuple(w.shape)}")
    # W' rounded to x's dtype: stored as bf16 for the tensor-core dx (16-byte
    # aligned rows), as fp32 for the CUDA-core dx
    wflip = w.to(x.dtype).flip(0, 1).transpose(2, 3)
    wflip = (wflip if dx_on_tensor_cores(x.dtype, cout) else wflip.float()).contiguous()
    if wflip.data_ptr() % 16:
        wflip = wflip.clone()
    parts = bwd_parts(tuple(x.shape), k, cout, x.dtype)
    partial = torch.empty((parts, k, k, cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, k, cin, cout), dtype=torch.float32, device=x.device)
    dx = _out_like(x, cin)
    # bf16: channels-last copies of x and g, which the kernels make, where they
    # are not channels-last already (the model's NCHW views)
    scratch = [torch.empty((b, h, wd, t.shape[3]), dtype=x.dtype, device=x.device)
               if x.dtype == torch.bfloat16 and not _channels_last_aligned(t) else None for t in (x, g)]
    rc = binding.kernel("smallc_conv", "cenet_smallc_conv_bwd", _BWD_ARGTYPES)(
        binding.is_bf16(x), *binding.ptrs(x, g, wflip, dx, partial, dw),
        *(None if t is None else t.data_ptr() for t in scratch), b, h, wd, cin, cout, k,
        *binding.strides(x, 4), *binding.strides(g, 4), *binding.strides(dx, 4), parts, binding.stream())
    binding.raise_on(name, rc)
    binding.LAUNCHES[name] += 1
    return dx, dw.to(w.dtype)


class ConvSmallCFn(torch.autograd.Function):
    """:func:`conv_small_c_fwd` with :func:`conv_small_c_bwd` as its backward
    (``_csc_fwd``/``_csc_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return conv_small_c_fwd(x, w, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv_small_c_bwd(x, w, g, ctx.padding)
        return dx, dw, None


def conv_small_c(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """Stride-1 K×K convolution, NHWC x, HWIO w: the kernels inside
    :func:`in_domain` (through :class:`ConvSmallCFn` when autograd records),
    ``F.conv2d`` outside it."""
    if not in_domain(tuple(x.shape), tuple(w.shape), padding):
        y = tF.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=padding)
        return y.permute(0, 2, 3, 1)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return ConvSmallCFn.apply(x, w, padding)
    return conv_small_c_fwd(x, w, padding)
