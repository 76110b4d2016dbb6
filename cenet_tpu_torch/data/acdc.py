"""ACDC cardiac-MRI dataset (reference ``datasets/dataset_acdc.py``).

A copy of ``cenet_tpu/data/acdc.py`` (the port imports nothing of the JAX
package). train/valid: per-slice ``.npz`` {img, label} under
``<root>/<split>/``; test: volume ``.npz`` under ``<root>/``; the list file
``<list_dir>/<split>.txt`` names each file with its extension. Train applies
the ``RandomGenerator`` (rot90/flip | rotate) and the zoom to img_size, with
NO intensity normalisation; for the same slice and ``np.random.Generator``
state it returns the same arrays as the JAX package. Samples stay numpy
(``image`` (H, W, 1) in train), as the loader stacks them; the trainer moves
them to NCHW tensors.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from cenet_tpu_torch.data.augment import random_generator


class ACDCDataset:
    def __init__(self, base_dir: str, list_dir: str, split: str, img_size: int = 224, preload: bool = True):
        self.split = split
        self.data_dir = base_dir
        self.img_size = img_size
        with open(os.path.join(list_dir, split + ".txt")) as f:
            self.sample_list = [line.strip() for line in f if line.strip()]
        self._cache: Optional[List] = None
        if preload:
            self._cache = [self._load(n) for n in self.sample_list]

    def _load(self, name: str):
        if self.split in ("train", "valid"):
            path = os.path.join(self.data_dir, self.split, name)
        else:
            path = os.path.join(self.data_dir, name)
        with np.load(path) as data:
            return data["img"].copy(), data["label"].copy()

    def __len__(self):
        return len(self.sample_list)

    def get_train(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        image, label = self._cache[idx] if self._cache is not None else self._load(self.sample_list[idx])
        image, label = random_generator(image.copy(), label.copy(), self.img_size, rng)
        return {
            "image": image[..., None].astype(np.float32),
            "label": label.astype(np.int32),
            "case_name": self.sample_list[idx],
        }

    def get_eval(self, idx: int) -> Dict[str, np.ndarray]:
        image, label = self._cache[idx] if self._cache is not None else self._load(self.sample_list[idx])
        return {"image": image, "label": label, "case_name": self.sample_list[idx]}

    def volumes(self):
        return (self.get_eval(i) for i in range(len(self)))
