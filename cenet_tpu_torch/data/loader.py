"""Deterministic host loader with background prefetch.

A copy of ``cenet_tpu/data/loader.py`` (the port imports nothing of the JAX
package). A thread pool builds batches ahead of the training loop (the
augmentation is numpy/scipy/OpenCV, which release the GIL), with an
``np.random.Generator`` per (seed, epoch, index), so the batches do not depend
on worker scheduling and equal the JAX package's for the same seed, epoch and
index (cf. the reference ``worker_init_fn``, ``main_synapse.py:167-168``).
``put_fn`` runs on the loader thread, so transfers overlap the step;
:func:`device_put_fn` is the one that moves a batch to the card (the default)
or to the device the caller names.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from cenet_tpu_torch.core.device import resolve_device


def seeded_epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)


def device_put_fn(device: Optional[Union[str, torch.device]] = None) -> Callable[[Dict], Dict]:
    """A ``put_fn`` that moves a batch to ``device`` (the card unless the caller
    names another; without CUDA that raises): ``image`` (B, H, W, C) becomes an
    fp32 (B, C, H, W) tensor with contiguous strides, ``label`` (B, H, W) an
    int32 tensor, both copied from pinned memory without blocking on the card;
    other keys pass through."""
    dev = resolve_device(device)

    def put(batch: Dict) -> Dict:
        # a fresh array: its strides are the canonical ones even where C is 1, where a
        # no-copy transpose would give C a stride of 1 and convolutions would take
        # the batch for channels-last (other kernels, other bits than a stacked copy)
        image = torch.from_numpy(batch["image"].transpose(0, 3, 1, 2).copy())
        label = torch.from_numpy(batch["label"])
        if dev.type == "cuda":
            image, label = image.pin_memory(), label.pin_memory()
        return {**batch, "image": image.to(dev, non_blocking=True), "label": label.to(dev, non_blocking=True)}

    return put


class Loader:
    """Iterates shuffled, batched, augmented samples for one epoch.

    ``get_sample(idx, rng)`` → dict of numpy arrays (other values are collected
    in lists). Batches are stacked and passed through ``put_fn`` on the loader
    thread. With ``rows=(index, parts)`` (a rank's data position and the data
    axis) only part ``index`` of each global batch of ``batch_size`` is built:
    the per-sample generators make them the rows that the one-process loader
    builds there.
    """

    def __init__(
        self,
        n_samples: int,
        get_sample: Callable[[int, np.random.Generator], Dict[str, np.ndarray]],
        batch_size: int,
        seed: int = 0,
        drop_last: bool = True,
        num_threads: int = 4,
        prefetch: int = 2,
        put_fn: Optional[Callable] = None,
        rows: Optional[Tuple[int, int]] = None,
    ):
        if rows is not None and batch_size % rows[1]:
            raise ValueError(f"a batch of {batch_size} does not split over {rows[1]} data ranks")
        self.n = n_samples
        self.get_sample = get_sample
        self.bs = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.put_fn = put_fn
        self.rows = rows

    def __len__(self):
        return self.n // self.bs if self.drop_last else -(-self.n // self.bs)

    def epoch(self, epoch: int) -> Iterator[Dict]:
        order = seeded_epoch_order(self.n, self.seed, epoch)
        n_batches = len(self)

        def sample_rng(idx):
            return np.random.default_rng(np.random.SeedSequence([self.seed, epoch, int(idx)]))

        def build_batch(b):
            idxs = order[b * self.bs : (b + 1) * self.bs]
            if self.rows is not None:
                index, parts = self.rows
                n = len(idxs) // parts
                idxs = idxs[index * n : (index + 1) * n]
            samples = [self.get_sample(int(i), sample_rng(i)) for i in idxs]
            batch = {}
            for k in samples[0]:
                if isinstance(samples[0][k], np.ndarray):
                    batch[k] = np.stack([s[k] for s in samples])
                else:
                    batch[k] = [s[k] for s in samples]
            if self.put_fn is not None:
                batch = self.put_fn(batch)
            return batch

        # each batch is one pool task; batches are yielded strictly in order, with
        # at most ``prefetch`` finished batches plus the tasks in flight ahead of
        # the consumer
        with ThreadPoolExecutor(max_workers=max(self.num_threads, 1)) as pool:
            window = max(self.num_threads, 1) + self.prefetch
            futures = {b: pool.submit(build_batch, b) for b in range(min(window, n_batches))}
            next_submit = len(futures)
            try:
                for b in range(n_batches):
                    batch = futures.pop(b).result()
                    if next_submit < n_batches:
                        futures[next_submit] = pool.submit(build_batch, next_submit)
                        next_submit += 1
                    yield batch
            finally:
                for f in futures.values():
                    f.cancel()
