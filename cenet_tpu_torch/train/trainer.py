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
next, as the JAX step's ``lax.scan`` does (``:166-183``). The eval step is
``evaluate/predict.py::make_predict_fn``. ``CENetOrg`` is not ported, so
``model_version='cenet_org'`` raises (``build_model``).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from cenet_tpu_torch.core.config import ExperimentConfig
from cenet_tpu_torch.core.device import resolve_device
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
                 device: Optional[Union[str, torch.device]] = None, model_seed: Optional[int] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg, device=self.device, seed=cfg.train.seed if model_seed is None else model_seed)
        self.criterion = Criterion(cfg.model.num_classes, cfg.train.loss_type, cfg.train.loss_weights)
        self.schedule = make_schedule(cfg.train.scheduler, cfg.train.base_lr, max_iterations,
                                      cfg.train.max_epochs, iters_per_epoch)
        self.optimizer = make_optimizer(cfg.train.optimizer, self.schedule, cfg.train.weight_decay,
                                        cfg.train.grad_clip)
        if cfg.model.freeze_bb:
            freeze_subtree(self.optimizer, "backbone")
        self.compute_dtype = torch.bfloat16 if cfg.train.amp else torch.float32
        self.generator = torch.Generator(device=self.device)
        set_generator(self.model, self.generator)

    @property
    def step(self) -> int:
        """Optimizer steps taken (optax's count)."""
        return self.optimizer.count

    def loss_and_grads(self, images: torch.Tensor, labels: torch.Tensor):
        """Loss (fp32, 0-d) and the gradient of every parameter (None where unused)
        for one batch in train mode; BatchNorm statistics update as a side effect."""
        params = list(self.model.parameters())
        out = self.model(images.to(self.compute_dtype))
        loss = self.criterion(out.float(), labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), grads

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One optimizer step. ``images`` (B, C, H, W), ``labels`` (B, H, W) on the
        trainer's device; with ``grad_accum_steps`` A > 1 they are stacked
        microbatches (A, b, C, H, W) and (A, b, H, W). Returns the loss as a
        device tensor (no host sync)."""
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
