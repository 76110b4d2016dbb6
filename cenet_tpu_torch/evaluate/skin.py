"""Skin (HAM10000/PH2) validation and test loops (reference ``utils/utils_skin.py``).

The port's copy of ``cenet_tpu/evaluate/skin.py``. val: per-batch binary dice
on the argmax (``utils_skin.py:97-113``); test: dice, pixel accuracy and IoU
(``utils_skin.py:131-170``), with an optional per-batch ``save_hook`` (the
CLI's contour overlays). ``predict_fn`` takes a batch's (B, C, H, W) image
tensor and returns (B, K, H, W) class probabilities; the argmax over K is
taken where they lie and only the labels come to the host, where the metrics
are the JAX package's numpy arithmetic, so the same probabilities give the
same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from cenet_tpu_torch.evaluate.metrics import iou_binary


def _batch_dice(pred: np.ndarray, gt: np.ndarray, smooth: float = 1e-5) -> float:
    """Per-batch binary dice on flattened masks (utils_skin.py:104-109 semantics)."""
    p = (pred > 0).astype(np.float64).reshape(-1)
    g = (gt > 0).astype(np.float64).reshape(-1)
    inter = (p * g).sum()
    return float((2 * inter + smooth) / (p.sum() + g.sum() + smooth))


def _labels(predict_fn: Callable, image) -> np.ndarray:
    """The argmax over the class axis of ``predict_fn(image)``, as numpy."""
    return predict_fn(image).argmax(1).cpu().numpy()


def skin_val(predict_fn: Callable, batches: Iterable[Dict]) -> float:
    """Mean per-batch dice over the validation loader."""
    dices = [_batch_dice(_labels(predict_fn, batch["image"]), np.asarray(batch["label"])) for batch in batches]
    return float(np.mean(dices))


def skin_test(
    predict_fn: Callable,
    batches: Iterable[Dict],
    save_hook: Optional[Callable] = None,
) -> Tuple[float, float, float]:
    """Returns (mean dice, mean pixel accuracy, mean IoU) over batches;
    ``save_hook(batch, pred)`` runs after each batch."""
    dices, accs, ious = [], [], []
    for batch in batches:
        pred = _labels(predict_fn, batch["image"])
        gt = np.asarray(batch["label"])
        dices.append(_batch_dice(pred, gt))
        accs.append(float(((pred > 0) == (gt > 0)).mean()))
        ious.append(iou_binary(pred, gt))
        if save_hook is not None:
            save_hook(batch, pred)
    return float(np.mean(dices)), float(np.mean(accs)), float(np.mean(ious))
