"""Small utilities mirroring the reference's ``utils/utils.py`` helpers.

A copy of ``cenet_tpu/core/misc.py`` (the port imports nothing of the JAX
package); numpy only.
"""

from __future__ import annotations

from itertools import chain, combinations
from typing import Iterable, List, Sequence

import numpy as np


class AvgMeter:
    """Running average with window (reference ``utils.py`` AvgMeter)."""

    def __init__(self, num: int = 40):
        self.num = num
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.losses: List[float] = []

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.losses.append(val)

    def show(self) -> float:
        tail = self.losses[max(len(self.losses) - self.num, 0):]
        return float(np.mean(tail)) if tail else 0.0


def powerset(iterable: Iterable) -> List[tuple]:
    """All non-empty subsets (reference ``utils.py`` powerset)."""
    s = list(iterable)
    return list(chain.from_iterable(combinations(s, r) for r in range(1, len(s) + 1)))


def one_hot_encoder(volume: np.ndarray, class_ids: Sequence[int]) -> np.ndarray:
    """Per-class binary stack of a label volume (reference MMWHS helper)."""
    return np.stack([(volume == c).astype(np.float32) for c in class_ids], axis=0)


def histogram_equalization_rgb(img: np.ndarray) -> np.ndarray:
    """Per-channel histogram equalization of an HWC uint8 image
    (reference ``utils_skin.py:30-40``, unused there)."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        chan = img[..., c]
        hist, _ = np.histogram(chan.flatten(), 256, (0, 256))
        cdf = hist.cumsum()
        nz = cdf[cdf > 0]
        if len(nz) == 0:
            out[..., c] = chan
            continue
        cdf_min = nz[0]
        lut = np.round((cdf - cdf_min) / max(cdf[-1] - cdf_min, 1) * 255).clip(0, 255).astype(np.uint8)
        out[..., c] = lut[chan]
    return out
