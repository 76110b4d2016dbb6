"""CENet and CENetOrg, on NCHW inputs. Mirrors ``cenet_tpu/models/cenet.py``.

CENet (reference ``networks/cenet/net.py``): grayscale→3ch replication,
encoder → Decoder → OutHead.

CENetOrg (reference ``networks/cenet_org/net.py``): a learned 1→3 conv stem,
encoder → DecoderOrg → an output head of its own (``enc``, ``up``, ``rb``,
``out``).

:func:`build_model` is the entry point that places a model on its device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from cenet_tpu_torch.core.config import ExperimentConfig
from cenet_tpu_torch.core.device import resolve_device
from cenet_tpu_torch.models.decoder import Decoder, DecoderOrg
from cenet_tpu_torch.models.encoder import make_encoder
from cenet_tpu_torch.models.out_head import OutHead
from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.blocks import UnetOutBlock, UnetResBlock, _Slot
from cenet_tpu_torch.nn.layers import BatchNorm, Conv2d


class CENet(nn.Module):
    def __init__(self, input_channels: int = 1, num_classes: int = 9, scale_factors: Sequence[float] = (0.8, 0.4),
                 diffatt_num_heads: Sequence[int] = (2, 2, 2), encoder: str = "pvt_v2_b2", skip_mode: str = "cat",
                 dec_up_block: str = "eucb", out_merge_mode: str = "cat", out_up_block: str = "eucb",
                 out_up_ks: int = 3, skip_use_command: str = "dat-fea", attn_impl: str = "pallas",
                 drop_path_rate: float = 0.1, remat: bool = False):
        super().__init__()
        enc_chans = 3 if input_channels == 1 else input_channels  # a grayscale input is replicated
        self.backbone, channels = make_encoder(encoder, input_channels=enc_chans, attn_impl=attn_impl,
                                               drop_path_rate=drop_path_rate, remat=remat)
        self.decoder = Decoder(channels=tuple(channels), scale_factors=scale_factors, skip_mode=skip_mode,
                               num_heads=diffatt_num_heads, up_block=dec_up_block,
                               skip_use_command=skip_use_command, attn_impl=attn_impl)
        self.out = OutHead(channels[-1], input_channels, num_classes, merge_mode=out_merge_mode,
                           up_block=out_up_block, up_ks=out_up_ks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x, x, x], dim=1) if x.shape[1] == 1 else x
        x1, x2, x3, x4 = self.backbone(y)
        return self.out(self.decoder(x4, [x3, x2, x1]), x)


class CENetOrg(nn.Module):
    """The cenet_org model (reference ``networks/cenet_org/net.py``). Torch keys:
    ``conv.0``, ``conv.1`` (the stem, for one input channel), ``backbone``,
    ``decoder``, ``enc.0``, ``up.1``, ``rb``, ``out``."""

    def __init__(self, input_channels: int = 1, num_classes: int = 9, scale_factors: Sequence[float] = (0.6, 0.3),
                 num_heads: Sequence[int] = (2, 2, 2), encoder: str = "pvt_v2_b2", skip_mode: str = "cat",
                 attn_impl: str = "pallas", drop_path_rate: float = 0.1):
        super().__init__()
        if input_channels == 1:  # the learned 1→3 stem (cenet_org/net.py:23-28)
            self.conv = nn.Sequential(Conv2d(1, 3, 1, bias=True), BatchNorm(3), _Slot())
        else:
            self.conv = None
        self.backbone, channels = make_encoder(encoder, input_channels=3, attn_impl=attn_impl,
                                               drop_path_rate=drop_path_rate)
        self.decoder = DecoderOrg(channels=tuple(channels), scale_factors=scale_factors, skip_mode=skip_mode,
                                  num_heads=num_heads, attn_impl=attn_impl)
        fine = channels[-1] // 2
        self.enc = nn.Sequential(UnetResBlock(input_channels, fine, 3, 1), _Slot())
        self.up = nn.Sequential(_Slot(), UnetResBlock(channels[-1], fine, 3, 1))
        self.rb = UnetResBlock(fine * 2, fine * 2, 3, 1)
        self.out = UnetOutBlock(fine * 2, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv[1](self.conv[0](x))) if self.conv is not None else x
        x1, x2, x3, x4 = self.backbone(y)
        deco = self.decoder(x4, [x3, x2, x1])
        # the raw input: rb → max pool (cenet_org/net.py:105); the decoder's map ×2 → rb (:106-107)
        enc = F.max_pool2d(self.enc[0](x), 2, 2)
        up = self.up[1](F.resize_bilinear_by_scale(deco, 2.0, align_corners=True))
        z = self.out(self.rb(torch.cat([up, enc], dim=1)))
        return F.resize_bilinear_by_scale(z, 2.0, align_corners=False)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every random initial weight of ``model`` from ``generator``, from
    the distributions the JAX package's modules name: each module of the port
    that draws random values does so in ``reset_parameters(generator)`` (the
    convs and linears of ``nn/layers.py`` by their ``weight_init`` and
    ``bias_init``; the gates, λ and σ of their own modules). Constants (norms,
    layer scales, the 0.5 gates) are left as constructed."""
    for mod in model.modules():
        if type(mod).__module__.startswith("cenet_tpu_torch.") and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator=generator)
    return model


def build_model(cfg: ExperimentConfig, device: Optional[Union[str, torch.device]] = None,
                seed: Optional[int] = None) -> nn.Module:
    """The configuration's model, CENet or (``model_version='cenet_org'``)
    CENetOrg as the JAX ``build_model`` builds them
    (``cenet_tpu/train/trainer.py:39-67``), on ``device`` (the card unless the
    caller names another), in eval mode, with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (a fresh seed when it is None). The
    global RNG is left as it was. ``train.remat`` recomputes each block of a
    CENet's PVT encoder in the backward (``models/pvtv2.py::checkpointed_block``);
    ResNet encoders and CENetOrg ignore it, as the JAX package's do."""
    dev = resolve_device(device)
    m = cfg.model
    if m.model_version not in ("cenet", "cenet_org"):
        raise ValueError(f"unknown model_version {m.model_version!r}")
    gen = torch.Generator()
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(seed)
    with torch.random.fork_rng(devices=[]):  # the constructors' own draws, all redrawn below
        if m.model_version == "cenet_org":
            model = CENetOrg(
                input_channels=m.input_channels, num_classes=m.num_classes, scale_factors=m.scale_factors[:2],
                num_heads=m.diffatt_num_heads, encoder=m.encoder, skip_mode=m.skip_mode, attn_impl=m.attn_impl,
                drop_path_rate=m.drop_path_rate,
            )
        else:
            model = CENet(
                input_channels=m.input_channels, num_classes=m.num_classes, scale_factors=m.scale_factors,
                diffatt_num_heads=m.diffatt_num_heads, encoder=m.encoder, skip_mode=m.skip_mode,
                dec_up_block=m.dec_up_block, out_merge_mode=m.out_merge_mode, out_up_block=m.out_up_block,
                out_up_ks=m.out_up_ks, skip_use_command=m.skip_use_command, attn_impl=m.attn_impl,
                drop_path_rate=m.drop_path_rate, remat=cfg.train.remat,
            )
    return init_weights_(model, gen).to(dev).eval()
