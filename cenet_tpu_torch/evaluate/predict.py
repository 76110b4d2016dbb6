"""The eval forward: counterpart of ``Trainer.make_eval_step`` (``cenet_tpu/train/trainer.py:235-247``).

The model runs in eval mode (set again on every call, since a trainer may have
put it in train mode between calls) on images cast to the compute dtype (bf16 under the
mixed-precision policy, fp32 otherwise) with its fp32 parameters cast at use,
and returns fp32 class probabilities (softmax over dim 1).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn


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
