"""CENet (reference ``networks/cenet/net.py``): grayscale→3ch replication,
encoder → Decoder → OutHead, on NCHW inputs.

Mirrors ``cenet_tpu/models/cenet.py::CENet``; ``CENetOrg`` is later work.
:func:`build_model` is the entry point that places a model on its device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from cenet_tpu_torch.core.config import ExperimentConfig
from cenet_tpu_torch.core.device import resolve_device
from cenet_tpu_torch.models.decoder import Decoder
from cenet_tpu_torch.models.encoder import make_encoder
from cenet_tpu_torch.models.out_head import OutHead
from cenet_tpu_torch.nn.attention import MultiheadDiffAttn
from cenet_tpu_torch.nn.dseb import FEA


class CENet(nn.Module):
    def __init__(self, input_channels: int = 1, num_classes: int = 9, scale_factors: Sequence[float] = (0.8, 0.4),
                 diffatt_num_heads: Sequence[int] = (2, 2, 2), encoder: str = "pvt_v2_b2", skip_mode: str = "cat",
                 dec_up_block: str = "eucb", out_merge_mode: str = "cat", out_up_block: str = "eucb",
                 out_up_ks: int = 3, skip_use_command: str = "dat-fea", attn_impl: str = "pallas",
                 drop_path_rate: float = 0.1):
        super().__init__()
        self.backbone, channels = make_encoder(encoder, attn_impl=attn_impl, drop_path_rate=drop_path_rate)
        self.decoder = Decoder(channels=tuple(channels), scale_factors=scale_factors, skip_mode=skip_mode,
                               num_heads=diffatt_num_heads, up_block=dec_up_block,
                               skip_use_command=skip_use_command, attn_impl=attn_impl)
        self.out = OutHead(channels[-1], input_channels, num_classes, merge_mode=out_merge_mode,
                           up_block=out_up_block, up_ks=out_up_ks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x, x, x], dim=1) if x.shape[1] == 1 else x
        x1, x2, x3, x4 = self.backbone(y)
        return self.out(self.decoder(x4, [x3, x2, x1]), x)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every random initial weight of ``model`` from ``generator``, with
    the distributions the modules' constructors use: torch's default for convs
    and linears, the modules' own ``reset_parameters`` for the gates and λ."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.modules.conv._ConvNd)):
                nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=generator)
                if mod.bias is not None:
                    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(mod.weight)
                    bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                    nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
            elif isinstance(mod, (FEA, MultiheadDiffAttn, OutHead)):
                mod.reset_parameters(generator=generator)
    return model


def build_model(cfg: ExperimentConfig, device: Optional[Union[str, torch.device]] = None,
                seed: Optional[int] = None) -> CENet:
    """The configuration's CENet on ``device`` (the card unless the caller names
    another), in eval mode, with random weights drawn from a ``torch.Generator``
    seeded with ``seed`` (a fresh seed when it is None). The global RNG is left
    as it was. Options not ported yet (``model_version`` other than ``'cenet'``,
    ``train.remat``) raise ``NotImplementedError``."""
    dev = resolve_device(device)
    m = cfg.model
    if m.model_version != "cenet":
        raise NotImplementedError(f"model_version {m.model_version!r} is not ported yet")
    if cfg.train.remat:
        raise NotImplementedError("train.remat (checkpointing the encoder's blocks) is not ported yet")
    gen = torch.Generator()
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(seed)
    with torch.random.fork_rng(devices=[]):  # the constructors' own draws, all redrawn below
        model = CENet(
            input_channels=m.input_channels, num_classes=m.num_classes, scale_factors=m.scale_factors,
            diffatt_num_heads=m.diffatt_num_heads, encoder=m.encoder, skip_mode=m.skip_mode,
            dec_up_block=m.dec_up_block, out_merge_mode=m.out_merge_mode, out_up_block=m.out_up_block,
            out_up_ks=m.out_up_ks, skip_use_command=m.skip_use_command, attn_impl=m.attn_impl,
            drop_path_rate=m.drop_path_rate,
        )
    return init_weights_(model, gen).to(dev).eval()
