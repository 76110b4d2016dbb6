"""Per-case figures of the volume evaluation.

A copy of ``save_im_gt_pd`` from ``cenet_tpu/evaluate/visualize.py`` (reference
``utils_synapse.py:26-48``), for ``cli eval --save_figs``; matplotlib is
imported at the call. The metric curves and skin overlays are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np


def save_im_gt_pd(image: np.ndarray, gt: np.ndarray, pred: np.ndarray, label: str, save_path: str):
    """Mid-slice image/GT/prediction triptych PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    idx = image.shape[0] // 2
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, (arr, title, cmap) in zip(
        axes,
        [(image[idx], "Image", "gray"), (gt[idx], "Ground Truth", None), (pred[idx], "Prediction", None)],
    ):
        ax.imshow(arr, cmap=cmap)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(save_path, f"te_{label}.jpg"))
    plt.close(fig)
