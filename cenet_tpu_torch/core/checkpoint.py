"""Checkpoints: the port's train-state snapshots, and loading weights for eval.

:class:`CheckpointManager` has the semantics of the JAX package's
(``cenet_tpu/core/checkpoint.py:31-121``): step-indexed snapshots of the whole
train state, of which the last ``keep`` are kept, and named tags (``best``,
``final``, ``epochN``). Its files are ``torch.save`` of plain tensors, ints
and dicts (``torch.load(weights_only=True)`` reads them), laid out as::

    <dir>/steps/<step>.pth     rotating step checkpoints
    <dir>/<tag>.pth            tags
    <dir>/metrics_<tag|step>.json

Each file is :meth:`Trainer.state_dict` on the CPU: the model's weights under
``"state_dict"`` with the reference's key names, and the optimizer under
``"optimizer"``. So ``cli eval --checkpoint <file>`` of either package reads a
tag: the port through :func:`load_torch_state_dict`, the JAX package through
``load_torch_checkpoint``, which unwraps ``"state_dict"``
(``cenet_tpu/convert/torch2jax.py:262-269``).

Weights for eval load from three sources (:func:`load_checkpoint`):

* ``.pth``: a reference PyTorch ``state_dict``, or a dict that holds one under
  ``"state_dict"``. The port's keys are the reference's keys, so it loads with
  ``load_state_dict(strict=True)`` and no converter.
* ``.npz``: the JAX package's flat format (``cenet_tpu/core/checkpoint.py:151-168``,
  keys ``params/…`` and ``batch_stats/…`` joined by ``/``), read by a copy of
  ``_load_npz`` and named with
  :func:`cenet_tpu_torch.convert.jax2torch.state_dict_from_jax`.
* a snapshot directory: its ``best``, then ``final``, then the numerically
  greatest ``epochN`` tag, then its latest step (the JAX CLI's fallback,
  ``cenet_tpu/cli/main.py:497-510``).

An Orbax directory (the JAX package's tags and steps) raises
``NotImplementedError``: Orbax imports JAX, and a bridge from its trees is
ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.core.mesh import shard_tensor

ORBAX_NOT_PORTED = ("restoring an Orbax checkpoint directory (the JAX package's tags and steps) is not ported yet "
                    "(ROADMAP queue 1 item 12); pass a .pth or .npz file or a snapshot of the port")
TAG_PRIORITY = ("best", "final")
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA")


def _is_orbax_dir(path: str) -> bool:
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Step-indexed snapshots and named tags (``best``, ``final``, ``epochN``)
    of a :class:`~cenet_tpu_torch.train.trainer.Trainer`'s whole state. Under a
    mesh every rank calls :meth:`save` (the trainer gathers its state), and
    only the manager made with ``write`` (rank 0's) writes; every rank reads,
    and a state written under one mesh restores under any other."""

    def __init__(self, directory: str, keep: int = 3, write: bool = True):
        self.directory = os.path.abspath(directory)
        self.steps_dir = os.path.join(self.directory, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        self.keep = keep
        self.write = write  # under a mesh: every rank saves (the state is gathered), rank 0 writes

    # -- save -----------------------------------------------------------------

    def save(self, step: int, trainer, metrics: Optional[Dict] = None, tag: Optional[str] = None):
        """A tag file when ``tag`` is given (replacing one of that name), else a
        step file, after which only the ``keep`` latest step files remain."""
        path = self.tag_path(tag) if tag is not None else self.step_path(step)
        state = _to_cpu(trainer.state_dict())
        if not self.write:
            return
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # no half-written checkpoint under the final name
        if tag is None:
            for old in self.all_steps()[: -self.keep]:
                os.remove(self.step_path(old))
        if metrics is not None:
            with open(os.path.join(self.directory, f"metrics_{tag or step}.json"), "w") as f:
                json.dump(metrics, f)

    def save_best(self, trainer, metrics: Optional[Dict] = None):
        self.save(0, trainer, metrics=metrics, tag="best")

    # -- restore ----------------------------------------------------------------

    def restore(self, trainer, step: Optional[int] = None, tag: Optional[str] = None):
        """Load a step (the latest when ``step`` and ``tag`` are None) or a tag
        into ``trainer``, weights and optimizer alike; returns the trainer."""
        if tag is not None:
            path = self.tag_path(tag)
        else:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no step checkpoints in {self.directory}")
            path = self.step_path(step)
        trainer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        return trainer

    def step_path(self, step: int) -> str:
        return os.path.join(self.steps_dir, f"{int(step)}.pth")

    def tag_path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.pth")

    def all_steps(self) -> List[int]:
        return _steps(self.steps_dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def available_tags(self) -> List[str]:
        """'best'/'final' first, then epochN tags in NUMERIC order (lexicographic
        sort would rank 'epoch80' > 'epoch120' and make fallbacks pick an older
        snapshot whenever epoch numbers cross a digit boundary)."""
        return _available_tags(self.directory)

    def has_any(self) -> bool:
        return self.latest_step() is not None or bool(self.available_tags())


def _steps(steps_dir: str) -> List[int]:
    if not os.path.isdir(steps_dir):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(steps_dir) if f.endswith(".pth") and f[:-4].isdigit())


def _available_tags(directory: str) -> List[str]:
    names = [f[:-4] for f in os.listdir(directory) if f.endswith(".pth")
             and os.path.isfile(os.path.join(directory, f))]
    epochs = [t for t in names if t.startswith("epoch") and t[5:].isdigit()]
    return [t for t in TAG_PRIORITY if t in names] + sorted(epochs, key=lambda t: int(t[5:]))


def snapshot_checkpoint(directory: str) -> str:
    """The file that eval loads from a snapshot directory: ``best``, then
    ``final``, then the numerically greatest ``epochN`` tag, then the latest
    step. Creates nothing; raises ``FileNotFoundError`` when the directory
    holds none of them, ``NotImplementedError`` when it is (or holds) an Orbax
    checkpoint instead."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint in {directory}; pass --checkpoint")
    if _is_orbax_dir(directory):
        raise NotImplementedError(ORBAX_NOT_PORTED)
    tags = _available_tags(directory)
    if tags:
        return os.path.join(directory, f"{next((t for t in TAG_PRIORITY if t in tags), tags[-1])}.pth")
    steps_dir = os.path.join(directory, "steps")
    steps = _steps(steps_dir)
    if steps:
        return os.path.join(steps_dir, f"{steps[-1]}.pth")
    subdirs = [os.path.join(directory, d) for d in os.listdir(directory)]
    subdirs += [os.path.join(steps_dir, d) for d in os.listdir(steps_dir)] if os.path.isdir(steps_dir) else []
    if any(_is_orbax_dir(d) for d in subdirs):
        raise NotImplementedError(ORBAX_NOT_PORTED)
    raise FileNotFoundError(f"no checkpoint in {directory}; pass --checkpoint")


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
    """Load the weights of ``path`` (``.pth``, ``.npz`` or a snapshot directory,
    :func:`snapshot_checkpoint`) into ``model`` strictly, onto the model's
    device; returns the model."""
    if os.path.isdir(path):
        path = snapshot_checkpoint(path)
    if path.endswith(".pth"):
        sd = load_torch_state_dict(path)
    elif path.endswith(".npz"):
        sd = state_dict_from_npz(path, model_version)
    else:
        raise ValueError(f"unknown checkpoint format: {path} (expected .pth or .npz)")
    model.load_state_dict(sd, strict=True)
    return model


def load_pretrained_encoder(model: nn.Module, pth_path: str, encoder_prefix: str = "backbone",
                            mesh=None, plan=None) -> Dict[str, List[str]]:
    """Load a torch PVT or ResNet (torchvision keys) checkpoint into
    ``model.<encoder_prefix>``, filtered like the reference (``encoder.py:75-84``:
    only the keys the backbone has), with a loud report instead of a silent
    skip. Returns ``{"missing": backbone keys the file lacks, "unused": file
    keys the backbone lacks}``. On a head-sharded model (``mesh`` and its
    ``plan``, ``core/mesh.py::shard_model_``) the rank's pieces are loaded."""
    sd = load_torch_state_dict(pth_path)
    backbone = getattr(model, encoder_prefix)
    own = backbone.state_dict()
    found = {k: v for k, v in sd.items() if k in own}
    for k, v in found.items():
        rule = (plan or {}).get(f"{encoder_prefix}.{k}")
        if rule is not None:
            found[k] = shard_tensor(v, *rule, mesh.m, mesh.model)
    backbone.load_state_dict({**own, **found}, strict=True)
    report = {"missing": sorted(set(own) - set(found)), "unused": sorted(set(sd) - set(own))}
    if report["missing"]:
        logging.getLogger(__name__).warning(
            "pretrained load: %d params not found in %s", len(report["missing"]), pth_path)
    return report
