"""The training step: counterpart of ``cenet_tpu/train/trainer.py``.

:class:`Trainer` owns the model, criterion, schedule, optimizer and the
generator of the stochastic layers. ``train_step`` is one optimizer step —
forward in train mode, loss, backward, BatchNorm statistics, update — run
eagerly on the trainer's device (the card unless the caller passes
``device="cpu"``). The compute policy is the JAX package's: images are cast
to bf16 under ``amp`` (``trainer.py:149``), parameters stay fp32 and are cast
at use, and the logits are cast to fp32 before the loss (``:155``); no
autocast. On the card the attention sites above the router's limit go through
the autograd Functions of ``ops/attention_kernels.py``, so the backward runs
the backward kernels.

``grad_accum_steps > 1`` takes stacked microbatches, averages their gradients
and losses, and threads the BatchNorm statistics from one microbatch to the
next, as the JAX step's ``lax.scan`` does (``:166-183``). ``eval_step`` is
the JAX ``trainer.eval_step`` over ``evaluate/predict.py::make_predict_fn``.
``state_dict``/``load_state_dict`` carry the whole train state, which
``core/checkpoint.py`` saves and restores. The model is ``build_model``'s:
CENet or, with ``model_version='cenet_org'``, CENetOrg, on any encoder;
``freeze_bb`` freezes its ``backbone`` (PVT or ResNet).

``mesh`` (``core/mesh.py``) runs the step on the ``('data', 'seq', 'model')``
mesh, one rank per process, without a ``DistributedDataParallel`` wrapper (its
reducer fires on ``.grad`` accumulation, which ``torch.autograd.grad`` never
does). The trainer registers its mesh before every step, so BatchNorm, the
losses, drop-path and the CCU take the global batch; under a model axis it
tags ``attn_impl`` with ``'@model'`` as the JAX ``Trainer`` does (not
``'ring'``, whose '@axis' names the seq axis) and shards the attention sites
whose heads divide it. ``train_step`` takes the rank's rows of the global
batch (``mesh.rows``; the ranks of a seq group take the same rows) and
averages every gradient over the data group after the backward. The ranks of
a seq group compute the same gradients, the ring sites' included (their
blocks are gathered); the card's nondeterministic kernels (cuDNN's weight
gradients, atomics) can still round them apart in the last bits, so the seq
group's first rank broadcasts its gradients to the others, and the replicas
never drift. Nothing is summed over ``seq``. ``state_dict`` is the gathered full state,
the same on every rank; ``load_state_dict`` takes a full one and shards it;
``eval_step`` takes the whole batch and returns all of it
(``evaluate/predict.py::shard_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.core.config import ExperimentConfig
from cenet_tpu_torch.core.device import resolve_device
from cenet_tpu_torch.evaluate.predict import make_predict_fn, shard_rows
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.nn.layers import set_generator
from cenet_tpu_torch.train.losses import Criterion
from cenet_tpu_torch.train.optim import freeze_subtree, make_optimizer, make_schedule


def step_seed(seed: int, step: int) -> int:
    """The seed of the stochastic layers' generator at optimizer step ``step``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


class Trainer:
    """Owns the model, its optimizer and the train step.

    ``model_seed`` seeds the random initial weights (``cfg.train.seed`` when
    None); drop-path and dropout draw from one ``torch.Generator`` on the
    device, reseeded from ``cfg.train.seed`` and the step count before every
    step, never from the global RNG.
    """

    def __init__(self, cfg: ExperimentConfig, max_iterations: int, iters_per_epoch: int = 1,
                 device: Optional[Union[str, torch.device]] = None, model_seed: Optional[int] = None,
                 mesh: Optional[M.Mesh] = None):
        # registered (or cleared) now and again before every step, so that a
        # trainer made later cannot leave this one with its mesh
        M.set_attention_mesh(mesh)
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
            impl = cfg.model.attn_impl
            # the JAX Trainer's tag (cenet_tpu/train/trainer.py:86-95); 'ring' names the seq axis
            if mesh.model > 1 and "@" not in impl and not impl.startswith("ring"):
                cfg = cfg.replace(model=dataclasses.replace(cfg.model, attn_impl=impl + "@model"))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg, device=self.device, seed=cfg.train.seed if model_seed is None else model_seed)
        self.tp_plan = {} if mesh is None else M.shard_model_(self.model, mesh)
        self.criterion = Criterion(cfg.model.num_classes, cfg.train.loss_type, cfg.train.loss_weights)
        self.schedule = make_schedule(cfg.train.scheduler, cfg.train.base_lr, max_iterations,
                                      cfg.train.max_epochs, iters_per_epoch)
        self.optimizer = make_optimizer(cfg.train.optimizer, self.schedule, cfg.train.weight_decay,
                                        cfg.train.grad_clip)
        if cfg.model.freeze_bb:
            freeze_subtree(self.optimizer, "backbone")
        if mesh is not None:
            self.optimizer.sharded = frozenset(self.tp_plan)
            self.optimizer.model_group = mesh.model_group
            self._check_replicas()
        self.compute_dtype = torch.bfloat16 if cfg.train.amp else torch.float32
        self.generator = torch.Generator(device=self.device)
        set_generator(self.model, self.generator)

    @property
    def step(self) -> int:
        """Optimizer steps taken (optax's count)."""
        return self.optimizer.count

    def _check_replicas(self) -> None:
        """Raise unless the ranks that should hold the same weights do: the
        replicated parameters on every rank, each sharded piece over its data
        group and its seq group (one float64 checksum each, compared by
        all-reduce)."""
        params = dict(self.model.named_parameters())
        checks = [(None, [n for n in params if n not in self.tp_plan]), (self.mesh.data_group, list(self.tp_plan))]
        if self.mesh.seq_group is not None:
            checks.append((self.mesh.seq_group, list(self.tp_plan)))
        for group, names in checks:
            total = torch.zeros(2, dtype=torch.float64, device=self.device)
            with torch.no_grad():
                for n in names:
                    p = params[n].double()
                    total += torch.stack([p.sum(), p.square().sum()])
            if not M.agree(total, group):
                raise RuntimeError("the ranks' initial weights differ; build every rank's model from the same seed")

    def _synced(self, grads):
        """Every gradient averaged over the data group, then the seq group's
        first rank's on every rank of the group: one all-reduce and one
        broadcast of all of them."""
        present = [g for g in grads if g is not None]
        if self.mesh.data_group is None or not present:
            return grads
        flat = torch.cat([g.reshape(-1) for g in present])
        torch.distributed.all_reduce(flat, group=self.mesh.data_group)
        if self.mesh.seq_group is not None:
            torch.distributed.broadcast(flat, src=self.mesh.seq_ranks[0], group=self.mesh.seq_group)
        pieces = iter(torch.split(flat / self.mesh.data, [g.numel() for g in present]))
        return [None if g is None else next(pieces).view_as(g) for g in grads]

    def state_dict(self) -> Dict:
        """The train state: ``{"state_dict": the model's parameters and buffers
        (BatchNorm running statistics and ``num_batches_tracked``) under the
        reference's key names, "optimizer": the optimizer's count and slots}``.

        No generator state is kept: drop-path and dropout reseed their generator
        from ``step_seed(cfg.train.seed, count)`` before every step, so the
        optimizer's count is the only random state a resume needs. Under a mesh
        the sharded weights and their slots are gathered: every rank returns the
        same full state, and a state saved under one mesh loads under any."""
        sd, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.tp_plan:
            sd = M.gather_state_dict(sd, self.mesh, self.tp_plan)
            opt["state"] = {n: {k: M.gather_tensor(t, *self.tp_plan[n], self.mesh) if n in self.tp_plan else t
                                for k, t in slots.items()} for n, slots in opt["state"].items()}
        return {"state_dict": sd, "optimizer": opt}

    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict()``'s output (strictly, onto the trainer's device);
        under a mesh the rank's pieces of the sharded tensors."""
        sd, opt = state["state_dict"], state["optimizer"]
        if self.tp_plan:
            sd = M.shard_state_dict(sd, self.mesh, self.tp_plan)
            opt = {**opt, "state": {n: {k: M.shard_tensor(t, *self.tp_plan[n], self.mesh.m, self.mesh.model)
                                        if n in self.tp_plan else t for k, t in slots.items()}
                                    for n, slots in opt["state"].items()}}
        self.model.load_state_dict(sd, strict=True)
        self.optimizer.load_state_dict(opt, device=self.device)

    def eval_step(self, images: torch.Tensor) -> torch.Tensor:
        """fp32 class probabilities (B, K, H, W) of ``images`` (B, C, H, W) in eval
        mode, without autograd; the next ``train_step`` returns to train mode.
        Under a mesh every rank passes the whole batch and gets all of it back."""
        predict = make_predict_fn(self.model, self.compute_dtype)
        return predict(images) if self.mesh is None else shard_rows(predict, self.mesh)(images)

    def loss_and_grads(self, images: torch.Tensor, labels: torch.Tensor):
        """Loss (fp32, 0-d) and the gradient of every parameter (None where unused)
        for one batch in train mode; BatchNorm statistics update as a side effect."""
        M.set_attention_mesh(self.mesh)
        params = list(self.model.parameters())
        out = self.model(images.to(self.compute_dtype))
        loss = self.criterion(out.float(), labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), grads

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One optimizer step. ``images`` (B, C, H, W), ``labels`` (B, H, W) on the
        trainer's device; with ``grad_accum_steps`` A > 1 they are stacked
        microbatches (A, b, C, H, W) and (A, b, H, W). Returns the loss as a
        device tensor (no host sync). Under a mesh they are the rank's rows of
        the global batch, and the loss is the global batch's."""
        M.set_attention_mesh(self.mesh)
        self.model.train()
        self.generator.manual_seed(step_seed(self.cfg.train.seed, self.step))
        accum = max(self.cfg.train.grad_accum_steps, 1)
        if accum == 1:
            loss, grads = self.loss_and_grads(images, labels)
        else:
            loss, grads = None, None
            for i in range(accum):
                li, gi = self.loss_and_grads(images[i], labels[i])
                loss = li if loss is None else loss + li
                grads = gi if grads is None else [
                    a if b is None else (b if a is None else a + b) for a, b in zip(grads, gi)]
            loss = loss / accum
            grads = [None if g is None else g / accum for g in grads]
        if self.mesh is not None:
            grads = self._synced(grads)
        params = dict(self.model.named_parameters())  # the order of loss_and_grads' gradients
        self.optimizer.step(params, dict(zip(params, grads)))
        return loss

    def multi_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """``train_step`` over batches stacked on a leading (n_steps,) axis; returns
        the last step's loss, as ``make_multi_step``'s scan does."""
        loss = None
        for i in range(images.shape[0]):
            loss = self.train_step(images[i], labels[i])
        return loss
