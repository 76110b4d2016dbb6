"""Volume/image metrics with exact medpy semantics (no medpy dependency).

The reference evaluates with ``medpy.metric.binary`` dc/hd95/jaccard/assd
(``utils/metrics_eval.py:10-22``, ``utils/utils_synapse.py:12-22``). medpy's surface
distances are defined as:

    border(m)  = m XOR binary_erosion(m, conn-1 structuring element, border_value=1)
    d(A→B)     = EDT(~border(B), sampling=voxelspacing)[border(A)]
    hd95       = max(P95(d(A→B)), P95(d(B→A)))
    assd       = mean(concat(d(A→B), d(B→A)))

A copy of ``cenet_tpu/evaluate/metrics.py``. The EDT is the repository's C++
``native/edt.cpp`` through the port's own loader (:mod:`cenet_tpu_torch.native`),
built at first use; a failed build raises rather than falling back to scipy,
whose ``distance_transform_edt`` is the plain version the tests hold it to.
Empty-mask conventions follow the reference call sites:
``calculate_metric_percase`` returns (1, 0) if only gt empty, (0, 0) if pred empty
(``utils_synapse.py:12-22``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from cenet_tpu_torch.native import edt

def _binary(x: np.ndarray) -> np.ndarray:
    return np.atleast_1d(np.asarray(x).astype(bool))


def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy ``dc``: 2|A∩B| / (|A|+|B|); 0.0 when both empty."""
    p, g = _binary(pred), _binary(gt)
    denom = p.sum() + g.sum()
    if denom == 0:
        return 0.0
    return 2.0 * np.count_nonzero(p & g) / float(denom)


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    p, g = _binary(pred), _binary(gt)
    union = np.count_nonzero(p | g)
    if union == 0:
        return 0.0
    return np.count_nonzero(p & g) / float(union)


def _surface_border(m: np.ndarray) -> np.ndarray:
    conn = ndimage.generate_binary_structure(m.ndim, 1)
    return m ^ ndimage.binary_erosion(m, structure=conn, iterations=1, border_value=1)


def _surface_distances(a: np.ndarray, b: np.ndarray, voxelspacing=None) -> np.ndarray:
    """Distances from border(a) voxels to border(b) (medpy ``__surface_distances``)."""
    a, b = _binary(a), _binary(b)
    if not a.any():
        raise RuntimeError("the first input does not contain any binary object")
    if not b.any():
        raise RuntimeError("the second input does not contain any binary object")
    border_a = _surface_border(a)
    border_b = _surface_border(b)
    return edt(~border_b, sampling=voxelspacing)[border_a]


def hd95(pred: np.ndarray, gt: np.ndarray, voxelspacing=None) -> float:
    """medpy ``hd95``: max of the two directed 95th-percentile surface distances."""
    d1 = _surface_distances(pred, gt, voxelspacing)
    d2 = _surface_distances(gt, pred, voxelspacing)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def assd(pred: np.ndarray, gt: np.ndarray, voxelspacing=None) -> float:
    """medpy ``assd``: mean of all surface distances in both directions."""
    d1 = _surface_distances(pred, gt, voxelspacing)
    d2 = _surface_distances(gt, pred, voxelspacing)
    return float(np.mean(np.hstack([d1, d2])))


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """Reference dice/hd95 per-class protocol incl. empty-mask conventions
    (``utils_synapse.py:12-22``)."""
    pred = np.asarray(pred).copy()
    gt = np.asarray(gt).copy()
    pred[pred > 0] = 1
    gt[gt > 0] = 1
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_coefficient(pred, gt), hd95(pred, gt)
    elif pred.sum() > 0 and gt.sum() == 0:
        return 1.0, 0.0
    else:
        return 0.0, 0.0


def calculate_metric_percase_full(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float, float, float]:
    """ACDC 4-metric protocol (``metrics_eval.py:10-22``): dice, hd95, jaccard, asd."""
    pred = np.asarray(pred).copy()
    gt = np.asarray(gt).copy()
    pred[pred > 0] = 1
    gt[gt > 0] = 1
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_coefficient(pred, gt), hd95(pred, gt), jaccard(pred, gt), assd(pred, gt)
    else:
        return 0.0, 0.0, 0.0, 0.0


def pixel_accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    """Skin eval pixel accuracy (``utils_skin.py:131-170``)."""
    pred = _binary(pred)
    gt = _binary(gt)
    return float((pred == gt).mean())


def iou_binary(pred: np.ndarray, gt: np.ndarray, smooth: float = 1e-6) -> float:
    """Skin eval IoU (``utils_skin.py:13-27``)."""
    p, g = _binary(pred), _binary(gt)
    inter = np.count_nonzero(p & g)
    union = np.count_nonzero(p | g)
    return float((inter + smooth) / (union + smooth))
