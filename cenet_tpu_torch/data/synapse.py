"""Synapse abdominal-CT dataset (reference ``datasets/dataset_synapse.py``).

A copy of ``cenet_tpu/data/synapse.py`` (the port imports nothing of the JAX
package). train: per-slice ``.npz`` {image, label} listed in
``<list_dir>/train.txt``, the ``SynapseAug`` pipeline, cubic/nearest zoom to
img_size and Normalize(0.5, 0.5) on the image; for the same slice and
``np.random.Generator`` state it returns the same arrays as the JAX package.
test: whole ``.npy.h5`` volumes {image, label} (``h5py`` is imported only there).

All train slices load into RAM once (the reference's DatasetFast mode,
``dataset_synapse.py:133-172``): the full train split is ~2.2k 512² slices.
Samples stay NHWC numpy (``image`` (H, W, 1)), as the loader stacks them; the
trainer moves them to NCHW tensors.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from scipy import ndimage

from cenet_tpu_torch.data.augment import SynapseAug


class SynapseDataset:
    def __init__(self, base_dir: str, list_dir: str, split: str, img_size: int = 224, preload: bool = True):
        self.split = split
        self.data_dir = base_dir
        self.img_size = img_size
        with open(os.path.join(list_dir, split + ".txt")) as f:
            self.sample_list = [line.strip() for line in f if line.strip()]
        self.aug = SynapseAug()
        self._cache: Optional[List] = None
        if preload and split == "train":
            self._cache = [self._load_slice(n) for n in self.sample_list]

    def __len__(self):
        return len(self.sample_list)

    def _load_slice(self, name: str):
        with np.load(os.path.join(self.data_dir, name + ".npz")) as data:
            return data["image"], data["label"]

    def get_train(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        image, label = self._cache[idx] if self._cache is not None else self._load_slice(self.sample_list[idx])
        image, label = self.aug(image.copy(), label.copy(), rng)
        h, w = image.shape
        if h != self.img_size or w != self.img_size:
            image = ndimage.zoom(image, (self.img_size / h, self.img_size / w), order=3)
            label = ndimage.zoom(label, (self.img_size / h, self.img_size / w), order=0)
        # ToTensor + Normalize(0.5, 0.5) (main_synapse.py:162-165)
        image = (image.astype(np.float32) - 0.5) / 0.5
        return {
            "image": image[..., None],
            "label": label.astype(np.int32),
            "case_name": self.sample_list[idx],
        }

    def get_volume(self, idx: int) -> Dict[str, np.ndarray]:
        import h5py

        vol_name = self.sample_list[idx]
        with h5py.File(os.path.join(self.data_dir, f"{vol_name}.npy.h5"), "r") as f:
            image, label = f["image"][:], f["label"][:]
        return {"image": image, "label": label, "case_name": vol_name}

    def volumes(self):
        return (self.get_volume(i) for i in range(len(self)))
