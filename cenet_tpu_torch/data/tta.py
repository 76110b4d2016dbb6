"""Test-time noise transforms (reference ``utils_synapse.py:101-147`` AddNoise,
unused by the reference eval but part of its API surface).

A copy of ``cenet_tpu/data/tta.py`` (the port imports nothing of the JAX
package): every noise type draws from one ``np.random.Generator``, so the same
generator state gives the same array as the JAX package.
"""

from __future__ import annotations

import numpy as np


class AddNoise:
    """salt_pepper | gaussian | poisson | speckle | none, on numpy arrays."""

    def __init__(self, noise_type: str = "none", rng: np.random.Generator | None = None, **params):
        self.noise_type = noise_type
        self.params = params
        self.rng = rng or np.random.default_rng(0)

    def set_params(self, **params):
        self.params = params

    def __call__(self, sample: np.ndarray) -> np.ndarray:
        fn = getattr(self, f"_{self.noise_type}", None)
        return fn(np.asarray(sample)) if fn else sample

    def _salt_pepper(self, x):
        salt = self.params.get("salt_prob", 0.05)
        pepper = self.params.get("pepper_prob", 0.05)
        y = x.copy()
        y[self.rng.random(x.shape) < salt] = 1
        y[self.rng.random(x.shape) < pepper] = 0
        return y

    def _gaussian(self, x):
        mean = self.params.get("mean", 0.0)
        std = self.params.get("std", 0.1)
        return x + self.rng.normal(mean, std, x.shape).astype(x.dtype)

    def _poisson(self, x):
        vals = 2 ** np.ceil(np.log2(max(len(np.unique(x)), 2)))
        return (self.rng.poisson(np.clip(x, 0, None) * vals) / vals).astype(x.dtype)

    def _speckle(self, x):
        std = self.params.get("std", 0.1)
        return x + x * self.rng.normal(0, std, x.shape).astype(x.dtype)
