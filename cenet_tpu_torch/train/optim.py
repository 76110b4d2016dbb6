"""Optimizers and LR schedules with the JAX package's (torch-reference) semantics.

Mirrors ``cenet_tpu/train/optim.py``, which builds them from optax:

* schedules (cosine/poly/exp/step/custom, stepped per iteration,
  ``core.py:27-41``) are plain functions of the step count, read once per step;
* :class:`Optimizer` applies the optax chains of ``make_optimizer`` in place:
  optional global-norm clipping, then SGD (L2-in-gradient weight decay,
  ``trace(decay=0.9)`` momentum), Adam (L2-in-gradient + ``scale_by_adam``) or
  AdamW (``scale_by_adam``, then decoupled decay), scaled by −lr(count). The
  count starts at 0, so the first step uses ``schedule(0)``, as optax's does;
* :func:`freeze_subtree` gives the parameters under one top-level module zero
  updates (optax ``multi_transform`` with ``set_to_zero``): no decay, no
  momentum, and they are left out of the clipping norm.

Under a mesh with a model axis the trainer names the head-sharded parameters
(``sharded``) and their ``model_group``: the clipping norm adds the squares of
the sharded gradients over the group, and counts the replicated ones once.

State lives on the parameters' device and no step reads a value back to the
host. ``state_dict``/``load_state_dict`` carry the count and every slot by
parameter name, so a fresh optimizer restored from them takes the same next
steps to the bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cenet_tpu_torch.core.mesh import all_reduce_sum


def make_schedule(name: str, base_lr: float, max_iterations: int, max_epochs: int = 0,
                  iters_per_epoch: int = 1) -> Callable[[int], float]:
    name = name.lower()
    if name == "poly":
        # (1 - t/T)^0.9 per iteration (core.py:31), clamped at 0 past T as the
        # JAX package clamps it (the reference would take a negative power)
        return lambda step: base_lr * max(1.0 - step / max_iterations, 0.0) ** 0.9
    if name == "cosine":
        # optax.cosine_decay_schedule(base_lr, max_iterations), alpha 0
        return lambda step: base_lr * 0.5 * (1.0 + math.cos(math.pi * min(step, max_iterations) / max_iterations))
    if name == "exp":
        return lambda step: base_lr * (0.95**step)
    if name == "step":
        return lambda step: base_lr * (0.5 ** (step // 200))
    if name == "custom":
        # two phases (core.py:191-212): linear from 10·lr to 5·lr over the first
        # five epochs, then cosine from lr to 0, driven by the epoch index
        t_first = 5
        lr_sh, lr_eh = 10 * base_lr, 5 * base_lr
        lr_sl, lr_el = base_lr, 0.0

        def sched(step):
            epoch = step // max(iters_per_epoch, 1)
            if epoch < t_first:
                return lr_sh - (lr_sh - lr_eh) * (epoch / t_first)
            p = (epoch - t_first) / max(max_epochs - t_first, 1)
            return lr_sl - (lr_sl - lr_el) * (0.5 * (1 - math.cos(math.pi * p)))

        return sched
    raise NotImplementedError(f"Scheduler <{name}> not implemented")


class Optimizer:
    """One of the JAX package's optax chains, applied in place to named tensors.

    ``step(params, grads)`` takes two dicts keyed by parameter name (a missing or
    None gradient counts as zero) and updates ``params`` under ``no_grad``.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam defaults

    def __init__(self, name: str, schedule: Callable[[int], float], weight_decay: float = 1e-4,
                 grad_clip: float = 0.0):
        self.name = name.lower()
        if self.name not in ("sgd", "adam", "adamw"):
            raise NotImplementedError(f"Optimizer {name} not implemented")
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.frozen_prefix: Optional[str] = None
        self.sharded: frozenset = frozenset()  # names of head-sharded parameters
        self.model_group = None  # the process group they are sharded over
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    def _trains(self, name: str) -> bool:
        return self.frozen_prefix is None or name.split(".")[0] != self.frozen_prefix

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, Optional[torch.Tensor]]) -> None:
        names = [n for n in params if self._trains(n)]
        ps = [params[n] for n in names]
        gs = [grads.get(n) if grads.get(n) is not None else torch.zeros_like(params[n]) for n in names]
        if self.grad_clip and self.grad_clip > 0:
            # optax.clip_by_global_norm: leave the gradients as they are below the
            # limit, else scale them by limit / norm (a device scalar: no sync)
            norm = self._global_norm(names, gs)
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
            gs = torch._foreach_mul(gs, scale)
        wd = self.weight_decay
        if self.name in ("sgd", "adam") and wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)  # optax.add_decayed_weights before the moments
        if self.name == "sgd":
            bufs = [self._slot(n, "trace", p) for n, p in zip(names, ps)]
            torch._foreach_mul_(bufs, 0.9)  # trace = g + 0.9·trace (torch momentum, dampening 0)
            torch._foreach_add_(bufs, gs)
            updates = bufs
        else:
            t = self.count + 1
            mu = [self._slot(n, "mu", p) for n, p in zip(names, ps)]
            nu = [self._slot(n, "nu", p) for n, p in zip(names, ps)]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, gs, alpha=1.0 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, gs, gs, value=1.0 - self.B2)
            # bias corrections in fp32, as optax computes 1 − decay^count
            one = np.float32(1.0)
            mu_hat = torch._foreach_div(mu, float(one - np.float32(self.B1) ** np.float32(t)))
            nu_hat = torch._foreach_div(nu, float(one - np.float32(self.B2) ** np.float32(t)))
            denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
            updates = torch._foreach_div(mu_hat, denom)
            if self.name == "adamw" and wd:
                updates = torch._foreach_add(updates, ps, alpha=wd)
        torch._foreach_add_(ps, updates, alpha=-self.schedule(self.count))
        self.count += 1

    def _global_norm(self, names, gs) -> torch.Tensor:
        norms = [torch.linalg.vector_norm(g) for g in gs]
        if self.model_group is None or not self.sharded:
            return torch.linalg.vector_norm(torch.stack(norms))
        rep = [x for n, x in zip(names, norms) if n not in self.sharded]
        part = [x for n, x in zip(names, norms) if n in self.sharded]
        sq = torch.stack(rep).square().sum() if rep else torch.zeros((), device=gs[0].device)
        if part:  # each rank holds its piece of these: sum the pieces' squares over the group
            sq = sq + all_reduce_sum(torch.stack(part).square().sum(), self.model_group)
        return sq.sqrt()

    def state_dict(self) -> Dict:
        """``{"count": int, "state": {name: {slot: tensor}}}``; slots are ``trace``
        (SGD) or ``mu`` and ``nu`` (Adam, AdamW), made at a parameter's first step."""
        return {"count": self.count, "state": {n: dict(slots) for n, slots in self.state.items()}}

    def load_state_dict(self, state_dict: Dict, device: Optional[torch.device] = None) -> None:
        """Restore ``state_dict`` (copies of its tensors, on ``device`` when given)."""
        self.count = int(state_dict["count"])
        self.state = {n: {s: t.detach().to(device=device, copy=True) for s, t in slots.items()}
                      for n, slots in state_dict["state"].items()}

    def _slot(self, name: str, slot: str, like: torch.Tensor) -> torch.Tensor:
        st = self.state.setdefault(name, {})
        if slot not in st:
            st[slot] = torch.zeros_like(like)
        return st[slot]


def make_optimizer(name: str, schedule: Callable[[int], float], weight_decay: float = 1e-4,
                   grad_clip: float = 0.0) -> Optimizer:
    """The torch-equivalent optimizers of the JAX package (see :class:`Optimizer`)."""
    return Optimizer(name, schedule, weight_decay, grad_clip)


def freeze_subtree(opt: Optimizer, frozen_prefix: str) -> Optimizer:
    """Zero updates for the parameters under the top-level module ``frozen_prefix``
    (reference ``freeze_bb``, ``encoder.py:67-73,82-84``)."""
    opt.frozen_prefix = frozen_prefix
    return opt
