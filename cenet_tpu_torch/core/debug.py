"""Debug utilities: NaN checks and finiteness sweeps of a train state.

Counterpart of ``cenet_tpu/core/debug.py``:

* ``nan_check_mode()`` — context manager over autograd's anomaly mode with its
  NaN check (``torch.autograd.set_detect_anomaly(True, check_nan=True)``);
* ``assert_finite(tree, name)`` — a host-side finiteness sweep of a
  ``state_dict`` or of nested dicts, lists and tuples of tensors (cheap, after
  a step; for tests and periodic health checks of a training run);
* ``tree_norm(tree)`` — the global L2 norm (gradient health logging).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Tuple

import torch


@contextlib.contextmanager
def nan_check_mode():
    """While open, autograd's anomaly mode checks every backward function's
    outputs for NaN and raises ``RuntimeError`` naming the function, with the
    forward's traceback of the operator that made it. Unlike the JAX package's
    ``jax_debug_nans`` it checks the backward's outputs only, and it does not
    re-run the forward operator by operator: a NaN made in a forward without
    autograd goes unseen (use :func:`assert_finite`). The previous mode is
    restored on exit."""
    prev, prev_nan = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_nan)


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming (at most 10 of) the floating-point
    tensors of ``tree`` that hold a NaN or an infinity."""
    bad: List[str] = [path for path, t in _leaves(tree)
                      if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def tree_norm(tree) -> float:
    """The global L2 norm of every tensor of ``tree``, squares summed in fp32."""
    sq = sum(float(torch.sum(torch.square(t.detach().float()))) for _, t in _leaves(tree))
    return math.sqrt(sq)
