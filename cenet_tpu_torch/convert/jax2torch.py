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


def state_dict_from_jax(variables: Dict[str, Any], model_version: str = "cenet") -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for JAX-package ``variables``."""
    siblings: Dict[str, set] = {}
    for collection in variables:
        for path, _ in _flatten(variables[collection]):
            for j in range(len(path)):
                siblings.setdefault("/".join(path[:j]), set()).add(path[j])
    sd: Dict[str, torch.Tensor] = {}
    for collection in variables:
        for path, leaf in _flatten(variables[collection]):
            key = torch_key_for(path, collection, model_version, siblings)
            # np.array, not np.ascontiguousarray, which makes a 0-d leaf (the Nonlocal
            # gates' ``w``) a (1,) array
            sd[key] = torch.from_numpy(np.array(_to_torch_layout(np.asarray(leaf), path), order="C"))
            if collection == "batch_stats" and key.endswith(".running_mean"):
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd
