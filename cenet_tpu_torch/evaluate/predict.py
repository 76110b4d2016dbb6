"""The eval forwards: counterparts of ``Trainer.make_eval_step`` and
``Trainer.make_multi_eval_step`` (``cenet_tpu/train/trainer.py:235-264``).

The model runs in eval mode (set again on every call, since a trainer may have
put it in train mode between calls) on images cast to the compute dtype (bf16 under the
mixed-precision policy, fp32 otherwise) with its fp32 parameters cast at use.
:func:`make_predict_fn` returns fp32 class probabilities (softmax over dim 1);
:func:`make_predict_many_fn` runs a stack of chunks and returns their labels,
the argmax of the logits in the compute dtype, as the JAX scan body takes it.
:func:`shard_rows` runs either over a mesh's data axis: every rank gets the
whole batch, forwards its rows and receives the others', as the JAX eval
step's batch rides ``'data'``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from cenet_tpu_torch.core import mesh as M


def make_predict_fn(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``predict(images (B, C, H, W)) -> probs (B, K, H, W)`` in fp32, on the model's device."""
    model.eval()

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        if model.training:
            model.eval()
        out = model(images.to(compute_dtype))
        return torch.softmax(out.float(), dim=1)

    return predict


def make_predict_many_fn(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``predict_many(images (k, c, 1, s, s)) -> labels (k, c, s, s)`` uint8, one
    forward per chunk of ``c`` slices, on the model's device."""
    model.eval()

    @torch.inference_mode()
    def predict_many(images: torch.Tensor) -> torch.Tensor:
        if model.training:
            model.eval()
        return torch.stack([model(chunk.to(compute_dtype)).argmax(dim=1).to(torch.uint8) for chunk in images])

    return predict_many


def shard_rows(fn: Callable, mesh: "M.Mesh") -> Callable:
    """``fn(images)`` over ``mesh``'s data axis: the batch (the same on every
    rank) is padded with zero rows to a multiple of ``data``, each rank runs
    ``fn`` on its rows, and every rank gets all rows back (the padding taken
    off), gathered over its data group. The layers read the real batch as the
    global one (``core.mesh.global_rows``). Every rank of the mesh must call it
    the same number of times."""
    M.set_attention_mesh(mesh)

    def run(images: torch.Tensor) -> torch.Tensor:
        M.set_attention_mesh(mesh)
        b = images.shape[0]
        pad = (-b) % mesh.data
        if pad:
            images = torch.cat([images, images.new_zeros((pad,) + tuple(images.shape[1:]))])
        with M.global_rows(b):
            out = fn(images[mesh.rows(b + pad)])
        return M.gather_cat(out, mesh.data_group, mesh.data)[:b]

    return run
