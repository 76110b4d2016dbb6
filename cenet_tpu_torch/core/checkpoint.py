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
* an Orbax checkpoint of the JAX package, a tag ``<snap>/<tag>/`` or a step
  ``<snap>/steps/<n>/``: its ``params`` and ``batch_stats``, read without JAX
  by :func:`cenet_tpu_torch.core.orbax.read_checkpoint` and named by
  ``state_dict_from_jax``;
* a snapshot directory: its ``best``, then ``final``, then the numerically
  greatest ``epochN`` tag, then its latest step (the JAX CLI's fallback,
  ``cenet_tpu/cli/main.py:497-510``).

A snapshot directory may hold both packages' files: a JAX run's Orbax tags
and steps, and the ``.pth`` files of the port resuming it. Both count, by one
rule: tags in the order above, steps by number, and where a tag or a step
exists in both formats the port's ``.pth`` is taken. So :meth:`restore`
resumes a JAX run from its latest Orbax step (momentum and count included,
through ``train_state_from_jax``) until the port has written a later one.
The port writes only ``.pth`` files and its rotation removes only its own;
the JAX package's files are never changed.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax, train_state_from_jax
from cenet_tpu_torch.core.mesh import shard_tensor
from cenet_tpu_torch.core.orbax import is_orbax_checkpoint, read_checkpoint

TAG_PRIORITY = ("best", "final")


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
            for old in _pth_steps(self.steps_dir)[: -self.keep]:  # the port's own files only
                os.remove(self.step_path(old))
        if metrics is not None:
            with open(os.path.join(self.directory, f"metrics_{tag or step}.json"), "w") as f:
                json.dump(metrics, f)

    def save_best(self, trainer, metrics: Optional[Dict] = None):
        self.save(0, trainer, metrics=metrics, tag="best")

    # -- restore ----------------------------------------------------------------

    def restore(self, trainer, step: Optional[int] = None, tag: Optional[str] = None):
        """Load a step (the latest of both formats when ``step`` and ``tag``
        are None) or a tag into ``trainer``, weights and optimizer alike: the
        port's ``.pth`` where it has one, else the JAX package's Orbax
        checkpoint; returns the trainer."""
        if tag is not None:
            path = _tag_source(self.directory, tag)
            if path is None:
                raise FileNotFoundError(f"no tag {tag!r} in {self.directory}")
        else:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no step checkpoints in {self.directory}")
            path = _step_source(self.steps_dir, step)
            if path is None:
                raise FileNotFoundError(f"no step {step} in {self.directory}")
        trainer.load_state_dict(load_train_state(path, trainer.cfg))
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


def _pth_steps(steps_dir: str) -> List[int]:
    if not os.path.isdir(steps_dir):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(steps_dir) if f.endswith(".pth") and f[:-4].isdigit())


def _steps(steps_dir: str) -> List[int]:
    """Step numbers of both formats: ``<n>.pth`` files and Orbax ``<n>/`` directories."""
    if not os.path.isdir(steps_dir):
        return []
    orbax = [int(f) for f in os.listdir(steps_dir)
             if f.isdigit() and is_orbax_checkpoint(os.path.join(steps_dir, f))]
    return sorted(set(_pth_steps(steps_dir)) | set(orbax))


def _step_source(steps_dir: str, step: int) -> Optional[str]:
    """The file or Orbax directory of ``step``: the ``.pth`` where both exist."""
    pth = os.path.join(steps_dir, f"{int(step)}.pth")
    if os.path.isfile(pth):
        return pth
    d = os.path.join(steps_dir, str(int(step)))
    return d if is_orbax_checkpoint(d) else None


def _tag_source(directory: str, tag: str) -> Optional[str]:
    """The file or Orbax directory of ``tag``: the ``.pth`` where both exist."""
    pth = os.path.join(directory, f"{tag}.pth")
    if os.path.isfile(pth):
        return pth
    d = os.path.join(directory, tag)
    return d if is_orbax_checkpoint(d) else None


def _available_tags(directory: str) -> List[str]:
    names = {f[:-4] for f in os.listdir(directory) if f.endswith(".pth")
             and os.path.isfile(os.path.join(directory, f))}
    names |= {f for f in os.listdir(directory) if is_orbax_checkpoint(os.path.join(directory, f))}
    epochs = [t for t in names if t.startswith("epoch") and t[5:].isdigit()]
    return [t for t in TAG_PRIORITY if t in names] + sorted(epochs, key=lambda t: int(t[5:]))


def snapshot_checkpoint(directory: str) -> str:
    """The file or Orbax directory that eval loads from ``directory``: the
    directory itself when it is one Orbax checkpoint; else, over both
    formats, ``best``, then ``final``, then the numerically greatest
    ``epochN`` tag, then the latest step, the port's ``.pth`` taken where a tag
    or step exists in both. Creates nothing; raises ``FileNotFoundError``
    when the directory holds none of them."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint in {directory}; pass --checkpoint")
    if is_orbax_checkpoint(directory):
        return directory
    tags = _available_tags(directory)
    if tags:
        return _tag_source(directory, next((t for t in TAG_PRIORITY if t in tags), tags[-1]))
    steps_dir = os.path.join(directory, "steps")
    steps = _steps(steps_dir)
    if steps:
        return _step_source(steps_dir, steps[-1])
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


def load_train_state(path: str, cfg) -> Dict:
    """The :meth:`Trainer.state_dict` held by ``path``: a ``.pth`` of the
    port, or an Orbax checkpoint of the JAX package's whole TrainState bridged
    by ``train_state_from_jax`` for ``cfg``'s model and optimizer."""
    if path.endswith(".pth"):
        return torch.load(path, map_location="cpu", weights_only=True)
    return train_state_from_jax(read_checkpoint(path), cfg.model.model_version, cfg.train.optimizer)


def load_checkpoint(model: nn.Module, path: str, model_version: str = "cenet") -> nn.Module:
    """Load the weights of ``path`` (``.pth``, ``.npz``, an Orbax tag or step
    of the JAX package, or a snapshot directory, :func:`snapshot_checkpoint`)
    into ``model`` strictly, onto the model's device; returns the model."""
    if os.path.isdir(path):
        path = snapshot_checkpoint(path)
    if os.path.isdir(path):
        sd = state_dict_from_jax(read_checkpoint(path, select=("params", "batch_stats")), model_version)
    elif path.endswith(".pth"):
        sd = load_torch_state_dict(path)
    elif path.endswith(".npz"):
        sd = state_dict_from_npz(path, model_version)
    else:
        raise ValueError(f"unknown checkpoint format: {path} (expected .pth, .npz or an Orbax directory)")
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
