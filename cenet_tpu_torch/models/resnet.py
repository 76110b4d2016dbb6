"""ResNet backbones returning 4-stage pyramids (reference ``networks/cenet/resnet.py``), NCHW.

Mirrors ``cenet_tpu/models/resnet.py``: the torchvision topology, a 7×7/2 stem
and a 3×3/2 max pool (padded with −inf), then ``layer1``..``layer4``, whose
outputs (strides 4/8/16/32) feed the decoder; no classifier head. The torch
keys are torchvision's (``conv1``, ``bn1``, ``layerN.i.convK``,
``layerN.i.downsample.{0,1}``), so a torchvision ``state_dict`` loads into the
backbone. Every conv is drawn from N(0, 2/fan_out), as the JAX package draws
them. BatchNorm follows the module's train/eval mode.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as tF

from cenet_tpu_torch.nn import functional as F
from cenet_tpu_torch.nn.layers import BatchNorm, Conv2d


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False, weight_init="fan_out")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        if stride != 1 or in_planes != planes * self.expansion:
            self.downsample = nn.Sequential(_conv(in_planes, planes * self.expansion, 1, stride),
                                            BatchNorm(planes * self.expansion))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = BatchNorm(planes * self.expansion)
        if stride != 1 or in_planes != planes * self.expansion:
            self.downsample = nn.Sequential(_conv(in_planes, planes * self.expansion, 1, stride),
                                            BatchNorm(planes * self.expansion))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, block: str, layers: Sequence[int], in_chans: int = 3):
        super().__init__()
        blk = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = _conv(in_chans, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        in_planes = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(blk(in_planes, planes, (1 if li == 0 else 2) if bi == 0 else 1))
                in_planes = planes * blk.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = tF.max_pool2d(x, 3, 2, 1)  # pads with −inf
        features = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            features.append(x)
        return features


RESNET_VARIANTS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def make_resnet(variant: str, in_chans: int = 3) -> ResNet:
    block, layers = RESNET_VARIANTS[variant]
    return ResNet(block, layers, in_chans=in_chans)
