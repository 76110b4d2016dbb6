"""JAX-package variables → the port's ``state_dict`` (reference torch key names).

The inverse of ``cenet_tpu/convert/torch2jax.py``: :func:`state_dict_from_jax`
walks the JAX package's ``{"params", "batch_stats"}`` tree (nested dicts of numpy
arrays), names every leaf with the reference torch key (a copy of
``torch_key_for`` and ``_org_rename``, ``torch2jax.py:54-176``) and undoes the
layout change of ``_to_jax_layout`` (``:178-205``):

* conv weights HWIO → OIHW; transposed-conv weights HWIO → (I, O, kh, kw);
* linear weights (in, out) → (out, in);
* the squeezed gates and layer scales (C,) → (1, C, 1, 1).

Every BatchNorm also gets the ``num_batches_tracked`` counter torch keeps, so
``load_state_dict(strict=True)`` takes the result, as it takes a reference ``.pth``.

:func:`train_state_from_jax` does the same for a whole TrainState read from
the JAX package's Orbax checkpoints (``core/orbax.py``): the weights as above,
and the optax state of each optimizer chain the JAX package builds as the
port's ``Optimizer.state_dict()``, each slot named and laid out as its
parameter.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


_UP_MODULE_RE = re.compile(r"^(up\d?|eucb\d)$")


def torch_key_for(
    path: Tuple[str, ...],
    collection: str,
    model_version: str = "cenet",
    siblings: Optional[Dict[str, set]] = None,
) -> str:
    """The reference torch ``state_dict`` key of a JAX-package variable path.

    ``siblings`` maps "/".join(parent path) → set of child names; it tells EUCB's
    ``bn`` (→ ``up_dwc.2``) from UpConv's (→ ``up.2``).
    """
    siblings = siblings or {}
    parts: List[str] = list(path)
    leaf = parts.pop()

    if collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    leaf = {"fc1_weight": "fc1.weight", "fc2_weight": "fc2.weight"}.get(leaf, leaf)

    def sibs(i: int) -> set:
        return siblings.get("/".join(parts[:i]), set())

    segs: List[str] = []
    for i, s in enumerate(parts):
        in_up_block = i > 0 and _UP_MODULE_RE.fullmatch(parts[i - 1]) is not None
        m = re.fullmatch(r"(block|layer)(\d)_(\d+)", s)  # PVT blocks, ResNet layers
        if m:
            segs.append(f"{m.group(1)}{m.group(2)}.{m.group(3)}")
            continue
        m = re.fullmatch(r"dlp(\d)", s)  # MultiOrderDWConv branches
        if m:
            segs.append(f"dlps.{m.group(1)}")
            continue
        fixed = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
                 "pool_conv": "dlps.3.1", "pool_bn": "dlps.3.2"}
        if s in fixed:
            segs.append(fixed[s])
            continue
        # up-block internals: EUCB up_dwc → up_dwc.1, bn → up_dwc.2, pwc → pwc.0;
        # UpConv conv → up.1, bn → up.2; UpRb rb → up.1
        if in_up_block:
            sib = sibs(i)
            if s == "up_dwc":
                segs.append("up_dwc.1")
                continue
            if s == "bn":
                segs.append("up_dwc.2" if "up_dwc" in sib else "up.2")
                continue
            if (s == "conv" and "bn" in sib) or s == "rb":
                segs.append("up.1")
                continue
            if s == "pwc":
                segs.append("pwc.0")
                continue
        if s == "pwc" and not any("srm" in g for g in segs):
            segs.append("pwc.0")
            continue
        segs.append(s)

    key = ".".join(segs + [leaf]) if segs else leaf
    if model_version == "cenet_org":
        key = _org_rename(key)
    # OutHead naming (cenet): out/{rb,out_rb,out_conv} → out.{rb.0, out.0, out.1}
    key = key.replace("out.out_rb.", "out.out.0.")
    key = key.replace("out.out_conv.conv.", "out.out.1.conv.conv.")
    key = re.sub(r"^out\.rb\.", "out.rb.0.", key)
    # monai Convolution wrapper: conv1/conv2/conv3 inside Unet blocks, UpTConv's up.
    # Not in the backbone: a ResNet's conv1..conv3 are torchvision's plain convs
    # (the JAX package's converter adds ".conv" there too, which no torchvision
    # state_dict has)
    if not key.startswith("backbone."):
        key = re.sub(r"\.(conv1|conv2|conv3)\.(weight|bias)$", r".\1.conv.\2", key)
    key = re.sub(r"\.up\.(weight|bias)$", r".up.conv.\1", key)
    return key


def _org_rename(key: str) -> str:
    key = key.replace(".mca.", ".attn.")
    key = key.replace(".ccu.", ".crm.")
    key = re.sub(r"decoder\.up(\d)\.", r"decoder.eucb\1.", key)
    key = key.replace("conv_stem_bn.", "conv.1.")
    key = key.replace("conv_stem.", "conv.0.")
    key = key.replace("enc_rb.", "enc.0.")
    key = key.replace("up_rb.", "up.1.")
    key = re.sub(r"^out\.conv\.(weight|bias)$", r"out.conv.conv.\1", key)
    return key


def _to_torch_layout(arr: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    leaf = path[-1]
    if arr.ndim == 4:
        if len(path) > 1 and path[-2] in ("up", "transp_conv"):  # ConvTranspose2d
            return arr.transpose(2, 3, 0, 1)
        return arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
    if arr.ndim == 2 and leaf == "weight":
        return arr.T
    if arr.ndim == 1 and (leaf == "w" or leaf.startswith("layer_scale")):
        return arr.reshape(1, -1, 1, 1)
    return arr


def torch_names(variables: Dict[str, Any], model_version: str = "cenet") -> Dict[Tuple[str, Tuple[str, ...]], str]:
    """``{(collection, path): torch key}`` of every leaf of JAX-package ``variables``."""
    siblings: Dict[str, set] = {}
    for collection in variables:
        for path, _ in _flatten(variables[collection]):
            for j in range(len(path)):
                siblings.setdefault("/".join(path[:j]), set()).add(path[j])
    return {(collection, path): torch_key_for(path, collection, model_version, siblings)
            for collection in variables for path, _ in _flatten(variables[collection])}


def _torch_tensor(leaf, path: Tuple[str, ...]) -> torch.Tensor:
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf (the Nonlocal
    # gates' ``w``) a (1,) array
    return torch.from_numpy(np.array(_to_torch_layout(np.asarray(leaf), path), order="C"))


def state_dict_from_jax(variables: Dict[str, Any], model_version: str = "cenet") -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for JAX-package ``variables``."""
    names = torch_names(variables, model_version)
    sd: Dict[str, torch.Tensor] = {}
    for collection in variables:
        for path, leaf in _flatten(variables[collection]):
            key = names[(collection, path)]
            sd[key] = _torch_tensor(leaf, path)
            if collection == "batch_stats" and key.endswith(".running_mean"):
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


# optax states of the chains ``cenet_tpu/train/optim.py:55-107`` builds, as an
# Orbax restore without a target gives them (namedtuple fields as dict keys,
# tuples as lists, empty states as None): field names → the port's slots
_SLOT_STATES = {frozenset({"trace"}): ("sgd", ("trace",)),  # optax.trace (SGD momentum)
                frozenset({"count", "mu", "nu"}): ("adam", ("mu", "nu"))}  # optax.scale_by_adam


def _optax_parts(state, slots: List, counts: List, where: str = "opt_state") -> None:
    """Walk an optax state tree: collect its slot trees ``(kind, slot, tree)``
    and its counts ``(where, value)``; raise on a state no chain of the JAX
    package makes."""
    if state is None or (isinstance(state, (list, tuple, dict)) and len(state) == 0):
        return  # EmptyState: clip_by_global_norm, add_decayed_weights, set_to_zero
    if isinstance(state, (list, tuple)):  # chain
        for i, s in enumerate(state):
            _optax_parts(s, slots, counts, f"{where}[{i}]")
        return
    if not isinstance(state, dict):
        raise ValueError(f"{where}: an optax state of type {type(state).__name__} is not one the JAX package makes")
    fields = frozenset(state)
    if fields in _SLOT_STATES:
        kind, names = _SLOT_STATES[fields]
        slots.extend((kind, n, state[n]) for n in names)
        if "count" in state:
            counts.append((f"{where}.count", state["count"]))
    elif fields == {"count"}:  # scale_by_learning_rate's schedule
        counts.append((f"{where}.count", state["count"]))
    elif fields == {"inner_states"}:  # multi_transform (freeze_subtree)
        for label, s in state["inner_states"].items():
            _optax_parts(s, slots, counts, f"{where}.inner_states[{label!r}]")
    elif fields == {"inner_state"}:  # masked
        _optax_parts(state["inner_state"], slots, counts, f"{where}.inner_state")
    else:
        raise ValueError(f"{where}: an optax state with fields {sorted(fields)} is not one the JAX package makes")


def train_state_from_jax(tree: Dict[str, Any], model_version: str = "cenet",
                         optimizer: Optional[str] = None) -> Dict[str, Any]:
    """A JAX-package TrainState (``{"params", "batch_stats", "opt_state",
    "step"}``, as :func:`cenet_tpu_torch.core.orbax.read_checkpoint` reads
    it) as the port's ``Trainer.state_dict()``: ``{"state_dict": …,
    "optimizer": {"count", "state": {name: {slot: tensor}}}}``.

    The weights go through :func:`state_dict_from_jax`. The optax state of any
    chain of ``make_optimizer`` and ``freeze_subtree``
    (``cenet_tpu/train/optim.py:55-107``) maps onto the port's
    ``Optimizer.state_dict()``: SGD's ``trace`` becomes the slot ``trace``;
    Adam's and AdamW's ``mu``/``nu`` the slots of those names; the empty
    states of the clip, the decay and ``set_to_zero`` carry nothing; a frozen
    (masked) parameter gets no slot. Each slot takes its parameter's key and
    layout. Adam's count, the schedule's count and ``step`` must agree: they
    become ``count``. ``optimizer`` (``sgd``, ``adam``, ``adamw``), when
    given, must be the one whose slots the state holds. Raises ``ValueError``
    otherwise."""
    for part in ("params", "opt_state", "step"):
        if part not in tree:
            raise ValueError(f"the train state has no {part!r} (it holds {sorted(tree)})")
    variables = {"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}}
    sd = state_dict_from_jax(variables, model_version)
    names = torch_names({"params": tree["params"]}, model_version)
    slots: List = []
    counts: List = []
    _optax_parts(tree["opt_state"], slots, counts)
    step = int(np.asarray(tree["step"]))
    for where, value in counts:
        if int(np.asarray(value)) != step:
            raise ValueError(f"{where} is {int(np.asarray(value))} but the train state's step is {step}")
    kinds = {kind for kind, _, _ in slots}
    if len(kinds) > 1 or len(slots) != len({s for _, s, _ in slots}):
        raise ValueError(f"the optax state holds more than one optimizer's slots: {[s for _, s, _ in slots]}")
    if optimizer is not None:
        want = "sgd" if optimizer.lower() == "sgd" else "adam"
        if kinds and kinds != {want}:
            raise ValueError(f"the optax state holds {kinds.pop()} slots, but the optimizer is {optimizer}")
        if not kinds:
            raise ValueError(f"the optax state holds no slots of {optimizer}")
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for _, slot, slot_tree in slots:
        for path, leaf in _flatten(slot_tree):
            if leaf is None:
                continue  # a frozen parameter (optax's MaskedNode)
            key = names.get(("params", path))
            if key is None:
                raise ValueError(f"optimizer slot {slot} at {'/'.join(path)} has no parameter")
            t = _torch_tensor(leaf, path)
            if t.shape != sd[key].shape:
                raise ValueError(f"optimizer slot {slot} of {key}: shape {tuple(t.shape)}, "
                                 f"parameter {tuple(sd[key].shape)}")
            state.setdefault(key, {})[slot] = t
    return {"state_dict": sd, "optimizer": {"count": step, "state": state}}
