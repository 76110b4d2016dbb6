"""Segmentation losses with the reference's semantics, on NCHW logits.

Mirrors ``cenet_tpu/train/losses.py`` (all of it). Logits are ``(B, K, H, W)``,
integer labels ``(B, H, W)``. Every loss is computed in fp32, and every
reduction is over the whole batch (the reference sums intersections over the
entire batch per class, not per sample), so class reductions run over
dims (0, 2, 3).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as tF


def one_hot_labels(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(B, H, W) int → (B, K, H, W) fp32 one-hot (reference ``core.py:49-55``)."""
    return tF.one_hot(labels.long(), n_classes).permute(0, 3, 1, 2).float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch ``CrossEntropyLoss`` (mean over all pixels), fp32."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, n_classes: int,
              weight: Sequence[float] | None = None, softmax: bool = True) -> torch.Tensor:
    """Reference ``DiceLoss`` (``core.py:44-80``): per-class whole-batch soft dice,
    smooth 1e-5, weighted sum / n_classes."""
    probs = torch.softmax(logits.float(), dim=1) if softmax else logits.float()
    target = one_hot_labels(labels, n_classes)
    smooth = 1e-5
    intersect = (probs * target).sum(dim=(0, 2, 3))
    y_sum = (target * target).sum(dim=(0, 2, 3))
    z_sum = (probs * probs).sum(dim=(0, 2, 3))
    dice = (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
    w = torch.ones(n_classes, device=logits.device) if weight is None else \
        torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
    return ((1.0 - dice) * w).sum() / n_classes


def _cross_neighbor_sum(t: torch.Tensor) -> torch.Tensor:
    """3×3 cross-kernel sum (self + 4 neighbours), zero-padded, over the last two
    dims: the reference's conv2d with kernel [[0,1,0],[1,1,1],[0,1,0]]
    (``core.py:97-105``), written as shifts as ``losses.py:49-56`` does."""
    p = tF.pad(t, (1, 1, 1, 1))
    return p[..., 1:-1, 1:-1] + p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]


def boundary_dou_loss(logits: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Reference ``BoundaryDoULoss`` (``core.py:83-131``).

    Per class: boundary fraction α from the cross-kernel interior count,
    truncated at 0.8; DoU loss (z+y−2i+s)/(z+y−(1+α)i+s); mean over classes.
    All classes at once: each (B, K, H, W) term reduces over dims (0, 2, 3).
    """
    score = torch.softmax(logits.float(), dim=1)
    target = one_hot_labels(labels, n_classes)
    smooth = 1e-5
    y = _cross_neighbor_sum(target) * target
    y = torch.where(y == 5.0, torch.zeros_like(y), y)
    c = (y != 0.0).sum(dim=(0, 2, 3)).float()
    s = (target != 0.0).sum(dim=(0, 2, 3)).float()
    alpha = 2.0 * (1.0 - (c + smooth) / (s + smooth)) - 1.0
    alpha = torch.clamp(alpha, max=0.8)
    intersect = (score * target).sum(dim=(0, 2, 3))
    y_sum = (target * target).sum(dim=(0, 2, 3))
    z_sum = (score * score).sum(dim=(0, 2, 3))
    loss = (z_sum + y_sum - 2.0 * intersect + smooth) / (z_sum + y_sum - (1.0 + alpha) * intersect + smooth)
    return loss.sum() / n_classes


def jaccard_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                 smooth: float = 1.0) -> torch.Tensor:
    """Reference ``JaccardLoss`` (``core.py:134-158``) with ignore-index masking."""
    n_classes = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    valid = (labels != ignore_index).float()[:, None]
    target = (labels.long()[:, None] == torch.arange(n_classes, device=logits.device)[:, None, None]).float() * valid
    p = probs * valid
    inter = (p * target).sum(dim=(0, 2, 3))
    union = (p + target).sum(dim=(0, 2, 3)) - inter
    return (1.0 - (inter + smooth) / (union + smooth)).mean()


class Criterion:
    """Weighted loss combination (reference ``Criterion``, ``core.py:161-188``).

    ``loss_type`` / ``loss_weights`` are comma-separated, e.g. "dice,ce" / "0.5,0.5".
    """

    def __init__(self, num_classes: int, loss_type: str = "dice,ce", loss_weights: str = "0.5,0.5"):
        self.num_classes = num_classes
        self.names = [s.strip() for s in loss_type.split(",")]
        self.weights = [float(s) for s in loss_weights.split(",")]
        if len(self.names) != len(self.weights):
            raise ValueError(f"{len(self.names)} losses but {len(self.weights)} weights")
        for n in self.names:
            if n not in ("dice", "ce", "boundary", "jaccard"):
                raise NotImplementedError(f"Loss {n} not implemented")

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for name, w in zip(self.names, self.weights):
            if name == "ce":
                total = total + w * cross_entropy_loss(logits, labels)
            elif name == "dice":
                total = total + w * dice_loss(logits, labels, self.num_classes, softmax=True)
            elif name == "boundary":
                total = total + w * boundary_dou_loss(logits, labels, self.num_classes)
            elif name == "jaccard":
                total = total + w * jaccard_loss(logits, labels)
        return total
