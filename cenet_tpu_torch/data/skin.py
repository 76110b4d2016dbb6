"""Skin lesion datasets: HAM10000 and PH2 (reference ``datasets/skin/``).

A copy of ``cenet_tpu/data/skin.py`` (the port imports nothing of the JAX
package). One-time preprocessing decodes and resizes every image and mask to
img_size² and caches them as ``np/X_tr_{s}x{s}.npy`` / ``np/Y_tr_{s}x{s}.npy``
(reference ``dataset_ham.py:140-263``); the dataset then serves uint8 HWC
images through :class:`SkinAug` in train, with min-max-normalised float
output and fixed index-based splits: HAM 7200/1800/1015, PH2 80/20/100. For
the same files and ``np.random.Generator`` state it returns the same arrays
as the JAX package.

PIL (decoding) and OpenCV (resizing) are imported only where a cache is
built, so a dataset over an existing cache needs neither of them here.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

from cenet_tpu_torch.data.augment import SkinAug

SPLITS = {
    "ham10000": {"train": (0, 7200), "val": (7200, 9000), "test": (9000, 10015)},
    "ph2": {"train": (0, 80), "val": (80, 100), "test": (100, 200)},
}


def _resize_img(arr: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    """``cv2.resize`` where OpenCV is installed, else PIL's resize."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(arr, (size, size), interpolation=interp)
    from PIL import Image

    img = Image.fromarray(arr)
    img = img.resize((size, size), Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(img)


def prepare_skin_cache(dataset: str, root: str, img_size: int = 224) -> Tuple[str, str]:
    """Decode + resize + cache all images/masks; returns (x_path, y_path).

    HAM10000 layout: images/ISIC_*.jpg + masks/ISIC_*_segmentation.png
    PH2 layout:      trainx/IMD*.bmp + trainy/IMD*_lesion.bmp
    """
    np_dir = os.path.join(root, "np")
    os.makedirs(np_dir, exist_ok=True)
    x_path = os.path.join(np_dir, f"X_tr_{img_size}x{img_size}.npy")
    y_path = os.path.join(np_dir, f"Y_tr_{img_size}x{img_size}.npy")
    if os.path.exists(x_path) and os.path.exists(y_path):
        return x_path, y_path

    if dataset == "ham10000":
        img_files = sorted(glob.glob(os.path.join(root, "images", "ISIC_*.jpg")))

        def mask_for(p):
            return os.path.join(root, "masks", os.path.basename(p).replace(".jpg", "_segmentation.png"))
    else:
        img_files = sorted(glob.glob(os.path.join(root, "trainx", "IMD*.bmp")))

        def mask_for(p):
            return os.path.join(root, "trainy", os.path.basename(p).replace(".bmp", "_lesion.bmp"))
    if not img_files:
        raise FileNotFoundError(f"no images found under {root}")
    from PIL import Image

    xs = np.zeros((len(img_files), img_size, img_size, 3), np.uint8)
    ys = np.zeros((len(img_files), img_size, img_size), np.uint8)
    for i, p in enumerate(img_files):
        with Image.open(p) as im:
            img = np.asarray(im.convert("RGB"))
        with Image.open(mask_for(p)) as im:
            msk = np.asarray(im.convert("L"))
        xs[i] = _resize_img(img, img_size)
        ys[i] = (_resize_img(msk, img_size, nearest=True) > 127).astype(np.uint8)
    np.save(x_path, xs)
    np.save(y_path, ys)
    return x_path, y_path


def _minmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    lo, hi = x.min(), x.max()
    out = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    return np.nan_to_num(out)


class SkinDataset:
    def __init__(self, dataset: str, root: str, split: str, img_size: int = 224):
        if dataset not in SPLITS:
            raise ValueError(f"unknown skin dataset {dataset!r}; one of {sorted(SPLITS)}")
        x_path, y_path = prepare_skin_cache(dataset, root, img_size)
        lo, hi = SPLITS[dataset][split]
        xs = np.load(x_path, mmap_mode="r")
        ys = np.load(y_path, mmap_mode="r")
        hi = min(hi, len(xs))
        self.images = np.asarray(xs[lo:hi])  # uint8 HWC
        self.labels = np.asarray(ys[lo:hi])
        self.split = split
        self.aug = SkinAug()

    def __len__(self):
        return len(self.images)

    def get_train(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img, msk = self.images[idx].copy(), self.labels[idx].copy()
        img, msk = self.aug(img, msk, rng)
        return {"image": _minmax(img), "label": msk.astype(np.int32)}

    def get_eval(self, idx: int) -> Dict[str, np.ndarray]:
        return {"image": _minmax(self.images[idx]), "label": self.labels[idx].astype(np.int32)}
