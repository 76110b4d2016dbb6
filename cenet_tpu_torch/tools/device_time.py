"""A kernel call's device time without the host's dispatch.

:func:`graph_ms` captures many calls of a function in one CUDA graph, replays
it and times the replays with CUDA events: the card runs the calls back to
back, so a call's time is the card's, not the Python loop's that a plain
event timing reads at small sizes (a wrapper's checks, allocation and ctypes
call cost tens of µs). The calls cycle through the argument sets of
:func:`rotated`, copies of the inputs in their own memory layout whose bytes
together pass twice the card's L2 cache, so each call reads its inputs from
memory, as a bound in bytes over the memory's rate assumes, and not from the
L2 where the previous call left them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch


def layout_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in new memory with ``t``'s strides and storage offset (so a
    view of NCHW memory stays one, and a slice keeps its alignment)."""
    base = torch.empty(t.untyped_storage().nbytes() // t.element_size(), dtype=t.dtype, device=t.device)
    out = base.as_strided(t.shape, t.stride(), t.storage_offset())
    out.copy_(t)
    return out


def rotated(tensors: Sequence[torch.Tensor], l2_multiple: float = 2.0) -> Sequence[Tuple[torch.Tensor, ...]]:
    """``tensors`` and copies of them (:func:`layout_copy`), as many sets as make
    their bytes together pass ``l2_multiple`` times the L2 cache of their card."""
    props = torch.cuda.get_device_properties(tensors[0].device)
    per_set = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, math.ceil(l2_multiple * props.L2_cache_size / per_set))
    return [tuple(tensors)] + [tuple(layout_copy(t) for t in tensors) for _ in range(n - 1)]


def graph_ms(fn: Callable, arg_sets: Sequence[tuple], calls: int = 20, replays: int = 3) -> float:
    """Mean ms of one ``fn(*args)`` on the card: a CUDA graph of at least
    ``calls`` calls, one per argument set in turn (every set at least once),
    captured after two warm-up calls on the capture stream (plans, caches and
    scratch kept per stream), replayed once, then ``replays`` times between two
    CUDA events."""
    n = max(calls, len(arg_sets))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    del graph
    return ms
