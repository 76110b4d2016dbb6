"""Model cost reporting: the parameter count, and the FLOPs and bytes of a forward.

Counterpart of ``cenet_tpu/core/stats.py`` (``count_params``, ``model_cost``,
``print_model_stats``; the reference's fvcore/thop startup printouts,
``utils/utils.py:102-128,171-198``). The JAX package reads XLA's cost analysis
of the compiled forward. The port counts the aten operators of the forward's
plain route instead, run on the ``meta`` device: shapes only, no memory, no
arithmetic. On the card the attention sites above the router's limit reach
hand-written kernels through ``ctypes``, which no operator count sees; on
``meta`` every site takes the router's plain math (``ops/router.py``), and the
ring core (``attn_impl='ring'``) its plain fallback with no collective, so
the count is the same for a model on the card or on the CPU, with its sites
routed or not, on a mesh or not, and for every ``attn_impl``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from cenet_tpu_torch.nn import attention


def count_params(model: nn.Module) -> int:
    """Elements of every parameter (BatchNorm running statistics are buffers, not counted)."""
    return sum(p.numel() for p in model.parameters())


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write for r in returns)


class _BytesMode(TorchDispatchMode):
    """Sums, over every aten operator on ``meta`` tensors that is not a view,
    the bytes of its tensor inputs and outputs. A copy of a host constant to
    the device (the resampling matrices, cached after a model's first forward)
    is not counted, so the count does not depend on what ran before."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            leaves, _ = tree_flatten((args, kwargs))
            inputs = [t for t in leaves if isinstance(t, torch.Tensor)]
            if all(t.device.type == "meta" for t in inputs):
                outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
                self.bytes += sum(t.numel() * t.element_size() for t in inputs + outs)
        return out


@contextlib.contextmanager
def _naive_diff_counted_as_plain():
    """While open, ``attention.diff_attention_naive`` (``attn_impl='xla'``)
    counts as the router's plain math (``router.diff_attention_plain``), which
    forms each group's product with V apart: one product of (B, h, N, M) weights
    with V more than the naive path forms. Yields a one-element list that
    collects those FLOPs."""
    naive, extra = attention.diff_attention_naive, [0]

    def counted(qs, k, v, lam, rel_pos=None):
        b, h2, n, _ = qs.shape
        extra[0] += 2 * b * (h2 // 2) * n * k.shape[2] * v.shape[-1]
        return naive(qs, k, v, lam, rel_pos)

    attention.diff_attention_naive = counted
    try:
        yield extra
    finally:
        attention.diff_attention_naive = naive


def model_cost(model: nn.Module, input_shape: Tuple[int, ...]) -> Dict[str, float]:
    """``params_m``, ``flops_g`` and ``bytes_accessed_gb`` of one eval-mode
    forward of ``model`` on a zero fp32 input of ``input_shape`` (N, C, H, W),
    as ``cenet_tpu/core/stats.py::model_cost`` reports them.

    The forward runs on ``meta`` copies of the parameters and buffers
    (``torch.func.functional_call``), whatever device the model is on; a model
    whose forward needs values (a data-dependent branch, ``.item()``) raises
    there. FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s: two per
    multiply-add of the matrix products and convolutions, nothing for
    elementwise operators, reductions or softmax (XLA counts those too, so the
    JAX package reads more). Every attention site counts as the router's plain
    math: a diff-attention site forms both groups' products with V, also where
    ``attn_impl='xla'`` merges the weights first and forms one. Bytes are the
    sum, over every aten operator of the plain route but views and copies of
    host constants to the device, of its inputs' and outputs' bytes: an upper
    bound of an unfused eager forward, not XLA's ``bytes accessed`` of a fused
    program, and not comparable with it."""
    state = {k: torch.empty_like(v, device="meta") for k, v in
             {**dict(model.named_parameters()), **dict(model.named_buffers())}.items()}
    x = torch.zeros(input_shape, dtype=torch.float32, device="meta")
    was_training = model.training
    model.eval()
    try:
        with (torch.no_grad(), _naive_diff_counted_as_plain() as extra, FlopCounterMode(display=False) as flops,
              _BytesMode() as nbytes):
            torch.func.functional_call(model, state, (x,))
    finally:
        model.train(was_training)
    return {
        "params_m": count_params(model) / 1e6,
        "flops_g": (flops.get_total_flops() + extra[0]) / 1e9,
        "bytes_accessed_gb": nbytes.bytes / 1e9,
    }


def print_model_stats(model: nn.Module, input_shape: Tuple[int, ...], log: Callable[[str], None] = print):
    """Log :func:`model_cost`'s line in the JAX package's format and return its numbers."""
    stats = model_cost(model, input_shape)
    log(
        f"model: {stats['params_m']:.2f} M params, "
        f"{stats['flops_g']:.2f} GFLOPs @ {input_shape}, "
        f"{stats['bytes_accessed_gb']:.2f} GB accessed"
    )
    return stats
