"""What every kernel wrapper of the port shares: the ctypes binding, the launch
counts and the checks on the tensors it hands over.

Each ``csrc/<source>.cu`` exposes plain C entry points that return a
``cudaError_t`` (0 on success). :func:`kernel` builds the source at first use
(:mod:`cenet_tpu_torch.ops.build`) and gives the entry point with its ctypes
signature, set once and kept for later calls. ``LAUNCHES`` counts kernel
launches by wrapper name, one per wrapper call that reaches the card (however
many CUDA kernels the call starts); a wrapper adds to it where it launches and
nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Sequence, Tuple

import torch

from cenet_tpu_torch.ops import build

P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741
L = ctypes.c_longlong

DTYPES = (torch.float32, torch.bfloat16)

# every wrapper that launches a kernel, by the TPU kernel it replaces (PERF.md)
LAUNCHES: Dict[str, int] = {
    "diff_attention_interleaved_fwd": 0, "attention_fwd": 0,  # K1, K2
    "diff_attention_interleaved_bwd": 0, "attention_bwd": 0,  # K3, K4
    "diff_attention_fwd": 0, "diff_attention_bwd": 0,  # K5, K6
    "diff_attention_bwd_split": 0, "attention_bwd_fused": 0,  # K7, K8
    "rms_norm": 0, "rotary": 0,  # K9, K10
    "depthwise_fwd": 0, "depthwise_dw": 0,  # K11
    "conv_small_c_fwd": 0, "conv_small_c_bwd": 0,  # K12
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_ENTRY_POINTS: Dict[Tuple[str, str], Callable[..., int]] = {}


def kernel(source: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built first if needed;
    its signature is set at the first call and the entry point kept."""
    fn = _ENTRY_POINTS.get((source, symbol))
    if fn is None:
        fn = getattr(build.load(source), symbol)
        fn.argtypes, fn.restype = list(argtypes), I
        _ENTRY_POINTS[(source, symbol)] = fn
    return fn


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptrs(*tensors: torch.Tensor):
    return [t.data_ptr() for t in tensors]


def strides(t: torch.Tensor, dims: int = 3):
    """The element strides of ``t``'s first ``dims`` dims."""
    return tuple(t.stride(i) for i in range(dims))


def last_offset(t: torch.Tensor) -> int:
    """The largest element offset of ``t`` from its first element."""
    return sum((n - 1) * st for n, st in zip(t.shape, t.stride()))


def raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def check_cuda_dtype(name: str, tensors: dict, dtype: torch.dtype) -> None:
    """Every tensor on CUDA and of ``dtype``, which must be float32 or bfloat16."""
    for tname, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {tname} is on {t.device}, the other inputs on CUDA")
        if t.dtype != dtype or dtype not in DTYPES:
            raise TypeError(f"{name}: {tname} is {t.dtype}; the kernel takes float32 or bfloat16, all alike")
