"""Per-case figures of the volume evaluation, the training run's metric curves
and the skin contour overlays.

Copies of ``save_im_gt_pd``, ``plot_metric_curves`` and ``skin_overlay`` from
``cenet_tpu/evaluate/visualize.py`` (reference ``utils_synapse.py:26-48``,
``utils.py:18-37``, ``utils_skin.py:44-93``), for ``cli eval --save_figs``
and ``cli train``; matplotlib is imported at the call.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

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


def plot_metric_curves(dices: Sequence[float], hd95s: Sequence[float], out_dir: str, stem: str = "result"):
    """``<stem>.tsv`` (byte-equal to the JAX package's), then dice/HD95 curves as
    ``<stem>.png`` where matplotlib imports; where it does not, a WARNING, so a
    machine without it still finishes the training run and keeps the numbers."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{stem}.tsv"), "w") as f:
        f.write("epoch\tdice\thd95\n")
        for i, (d, h) in enumerate(zip(dices, hd95s)):
            f.write(f"{i}\t{d}\t{h}\n")
    try:
        import matplotlib
    except ImportError as e:
        logging.getLogger(__name__).warning("matplotlib unavailable (%s) — metric curves kept only in %s",
                                            e, os.path.join(out_dir, f"{stem}.tsv"))
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 4))
    a1.plot(dices)
    a1.set_title("mean dice")
    a2.plot(hd95s)
    a2.set_title("mean hd95")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"{stem}.png"))
    plt.close(fig)


def skin_overlay(image: np.ndarray, gt: np.ndarray, pred: np.ndarray, path: str):
    """Contour overlay of GT (green) and prediction (red) on the RGB image
    (HWC, or CHW as the port's batches hold it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 5))
    img = image
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = np.transpose(img, (1, 2, 0))
    ax.imshow(np.clip(img, 0, 1) if img.dtype != np.uint8 else img)
    ax.contour(gt > 0, colors="g", linewidths=1.2)
    ax.contour(pred > 0, colors="r", linewidths=1.2)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
