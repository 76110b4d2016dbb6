"""Encoder factory (reference ``networks/cenet/encoder.py:6-88``).

Mirrors ``cenet_tpu/models/encoder.py``: the PVTv2 b0–b5 and ResNet-18…152
backbones and their channel lists, deepest first; an unknown name falls back to
pvt_v2_b2 with a warning, as the reference does (``encoder.py:48-52``).
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import torch.nn as nn

from cenet_tpu_torch.models.pvtv2 import PVT_VARIANTS, make_pvt
from cenet_tpu_torch.models.resnet import RESNET_VARIANTS, make_resnet

ENCODER_CHANNELS = {
    "pvt_v2_b0": [256, 160, 64, 32],
    "pvt_v2_b1": [512, 320, 128, 64],
    "pvt_v2_b2": [512, 320, 128, 64],
    "pvt_v2_b3": [512, 320, 128, 64],
    "pvt_v2_b4": [512, 320, 128, 64],
    "pvt_v2_b5": [512, 320, 128, 64],
    "resnet18": [512, 256, 128, 64],
    "resnet34": [512, 256, 128, 64],
    "resnet50": [2048, 1024, 512, 256],
    "resnet101": [2048, 1024, 512, 256],
    "resnet152": [2048, 1024, 512, 256],
}


def make_encoder(encoder: str, input_channels: int = 3, attn_impl: str = "xla",
                 drop_path_rate: float = 0.1, remat: bool = False) -> Tuple[nn.Module, List[int]]:
    """The backbone and its channel list; its stem takes ``input_channels``, the
    channels the model hands it (3 for a grayscale image, which CENet
    replicates, ``net.py:55``, and CENetOrg maps with a learned conv; reference
    ``encoder.py:54-66``). ``remat`` reaches a named PVT encoder only: the
    ResNets and the unknown-name fallback ignore it, as the JAX package's do."""
    if encoder in RESNET_VARIANTS:
        return make_resnet(encoder, in_chans=input_channels), ENCODER_CHANNELS[encoder]
    if encoder not in PVT_VARIANTS:
        logging.getLogger(__name__).warning("unknown encoder %r: using pvt_v2_b2", encoder)
        encoder, remat = "pvt_v2_b2", False
    return (make_pvt(encoder, in_chans=input_channels, attn_impl=attn_impl, drop_path_rate=drop_path_rate,
                     remat=remat),
            ENCODER_CHANNELS[encoder])
