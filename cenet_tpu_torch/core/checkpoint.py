"""Loading a checkpoint into the port's model (saving is not ported yet).

Two formats, told apart by their suffix:

* ``.pth``: a reference PyTorch ``state_dict``, or a dict that holds one under
  ``"state_dict"`` (unwrapped as ``cenet_tpu/convert/torch2jax.py:262-269``
  does). The port's keys are the reference's keys, so it loads with
  ``load_state_dict(strict=True)`` and no converter.
* ``.npz``: the JAX package's flat format (``cenet_tpu/core/checkpoint.py:151-168``,
  keys ``params/…`` and ``batch_stats/…`` joined by ``/``), read by a copy of
  ``_load_npz`` and named with
  :func:`cenet_tpu_torch.convert.jax2torch.state_dict_from_jax`.

An Orbax tag directory or a snapshot directory (the JAX CLI's fallbacks to
``best``, ``final`` or the last epoch) raises ``NotImplementedError``: Orbax
imports JAX, and restoring its trees is ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax

ORBAX_NOT_PORTED = ("restoring an Orbax checkpoint directory (a tag directory or a snapshot's best/final/epoch "
                    "fallback) is not ported yet (ROADMAP queue 1 item 5); pass a .pth or .npz file")


def _load_npz(path: str) -> Dict:
    """A copy of the JAX package's ``_load_npz``: the flat ``a/b/c`` keys back into nested dicts."""
    data = np.load(path, allow_pickle=False)
    tree: Dict = {}
    for key in data.files:
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = data[key]
    return tree


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's state_dict on the CPU, unwrapped from ``{"state_dict": …}``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def state_dict_from_npz(path: str, model_version: str = "cenet") -> Dict[str, torch.Tensor]:
    """A JAX-format ``.npz`` file's ``params`` and ``batch_stats`` as the port's state_dict."""
    tree = _load_npz(path)
    return state_dict_from_jax({c: tree[c] for c in ("params", "batch_stats") if c in tree}, model_version)


def load_checkpoint(model: nn.Module, path: str, model_version: str = "cenet") -> nn.Module:
    """Load the weights of ``path`` (``.pth`` or ``.npz``) into ``model``
    strictly, onto the model's device; returns the model."""
    if os.path.isdir(path):
        raise NotImplementedError(ORBAX_NOT_PORTED)
    if path.endswith(".pth"):
        sd = load_torch_state_dict(path)
    elif path.endswith(".npz"):
        sd = state_dict_from_npz(path, model_version)
    else:
        raise ValueError(f"unknown checkpoint format: {path} (expected .pth or .npz)")
    model.load_state_dict(sd, strict=True)
    return model
