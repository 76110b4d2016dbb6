"""CENet decoders, NCHW: the cenet cascade (reference ``networks/cenet/decoders.py:35-105``)

    dec4 → up3 → DSEB3 → dec3 → up2 → DSEB2 → dec2 → up1 → DSEB1 → dec1

and the cenet_org variant (reference ``networks/cenet_org/decoders.py:148-197``):
fixed EUCB up blocks with ReLU (``eucb{i}``), SkipEnhancer skips, and CFAMs at
rates (6, 12, 18) with a ReLU image-pool branch. Mirrors
``cenet_tpu/models/decoder.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cenet_tpu_torch.nn.blocks import EUCB, make_up_block
from cenet_tpu_torch.nn.cfam import CFAModule
from cenet_tpu_torch.nn.dseb import DSEBlock, SkipEnhancer

# Per-level MCA dilation rates, decoder levels 56/28/14/7 (reference ``decoders.py:64``).
MCA_RATES_LIST = [[2, 3, 5], [1, 2, 4], [1, 2, 3], [1, 2, 2]]


class Decoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (512, 320, 128, 64), scale_factors: Sequence[float] = (0.8, 0.4),
                 skip_mode: str = "add", num_heads: Sequence[int] = (2, 2, 2), up_block: str = "eucb",
                 skip_use_command: str = "dat-fea", attn_impl: str = "xla"):
        super().__init__()
        ch = channels

        def cfam(dim, rates):
            return CFAModule(dim, ffn_ratio=4, drop_rate=0.0, drop_path_rate=0.0, act_type="gelu",
                             norm_type="BN", init_value=1e-6, attn_act_type="silu", mca_rates=rates,
                             attn_impl=attn_impl)

        def dseb(dim, heads, depth):
            return DSEBlock(dim, scale_factors=scale_factors, num_heads=heads, mode=skip_mode,
                            use_command=skip_use_command, depth=depth, attn_impl=attn_impl)

        self.dec4 = cfam(ch[0], MCA_RATES_LIST[3])
        self.up3 = make_up_block(up_block, ch[0], ch[1], 3)
        self.skip_enhancer3 = dseb(ch[1], num_heads[0], 4)
        self.dec3 = cfam(ch[1], MCA_RATES_LIST[2])
        self.up2 = make_up_block(up_block, ch[1], ch[2], 3)
        self.skip_enhancer2 = dseb(ch[2], num_heads[1], 3)
        self.dec2 = cfam(ch[2], MCA_RATES_LIST[1])
        self.up1 = make_up_block(up_block, ch[2], ch[3], 3)
        self.skip_enhancer1 = dseb(ch[3], num_heads[2], 2)
        self.dec1 = cfam(ch[3], MCA_RATES_LIST[0])

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        d4 = self.dec4(x)
        d3 = self.up3(d4)
        d3 = self.dec3(d3 + self.skip_enhancer3(skips[0], d3))
        d2 = self.up2(d3)
        d2 = self.dec2(d2 + self.skip_enhancer2(skips[1], d2))
        d1 = self.up1(d2)
        return self.dec1(d1 + self.skip_enhancer1(skips[2], d1))


class DecoderOrg(nn.Module):
    """cenet_org decoder (reference ``cenet_org/decoders.py:148-197``). Torch keys
    as the reference's: ``dec{i}`` (their MCA as ``attn``, CCU as ``crm``),
    ``eucb{i}``, ``skip_enhancer{i}``."""

    def __init__(self, channels: Sequence[int] = (512, 320, 128, 64), scale_factors: Sequence[float] = (0.8, 0.4),
                 skip_mode: str = "add", num_heads: Sequence[int] = (2, 2, 2), attn_force_fp32: bool = False,
                 attn_impl: str = "xla"):
        super().__init__()
        ch = channels

        def cfam(dim):
            return CFAModule(dim, ffn_ratio=4, drop_rate=0.0, drop_path_rate=0.0, act_type="gelu", norm_type="BN",
                             init_value=1e-6, attn_act_type="silu", mca_rates=(6, 12, 18),
                             attn_force_fp32=attn_force_fp32, pool_act="relu", attn_impl=attn_impl, org_names=True)

        def skip_enh(dim, heads):
            return SkipEnhancer(dim, scale_factors=scale_factors, num_heads=heads, mode=skip_mode,
                                attn_impl=attn_impl)

        # cenet_org's EUCB keeps its default ReLU (cenet_org/decoders.py:86,171)
        self.dec4 = cfam(ch[0])
        self.eucb3 = EUCB(ch[0], ch[1], 3, stride=1, activation="relu")
        self.skip_enhancer3 = skip_enh(ch[1], num_heads[0])
        self.dec3 = cfam(ch[1])
        self.eucb2 = EUCB(ch[1], ch[2], 3, stride=1, activation="relu")
        self.skip_enhancer2 = skip_enh(ch[2], num_heads[1])
        self.dec2 = cfam(ch[2])
        self.eucb1 = EUCB(ch[2], ch[3], 3, stride=1, activation="relu")
        self.skip_enhancer1 = skip_enh(ch[3], num_heads[2])
        self.dec1 = cfam(ch[3])

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        d4 = self.dec4(x)
        d3 = self.eucb3(d4)
        d3 = self.dec3(d3 + self.skip_enhancer3(skips[0], d3))
        d2 = self.eucb2(d3)
        d2 = self.dec2(d2 + self.skip_enhancer2(skips[1], d2))
        d1 = self.eucb1(d2)
        return self.dec1(d1 + self.skip_enhancer1(skips[2], d1))
