"""ResNet encoders 18/34/50/101/152 as a 6-level feature pyramid.

The port of octseg/models/encoders/resnet.py at output stride 32 (what the
Unet and UNet++ decoders use), with torchvision's module names
(``conv1``/``bn1``/``layer{1..4}.{b}.conv{i}/bn{i}/downsample``), which is
how SMP's resnet encoders name their weights.

``forward(x) -> [x, f1, ..., f5]`` with f_i at spatial stride 2**i.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import BatchNorm2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


# variant -> (block, blocks per stage)
RESNETS = {
    'resnet18': (BasicBlock, (2, 2, 2, 2)),
    'resnet34': (BasicBlock, (3, 4, 6, 3)),
    'resnet50': (Bottleneck, (3, 4, 6, 3)),
    'resnet101': (Bottleneck, (3, 4, 23, 3)),
    'resnet152': (Bottleneck, (3, 8, 36, 3)),
}


def resnet_out_channels(variant: str) -> Sequence[int]:
    block, _ = RESNETS[variant]
    m = block.expansion
    return (3, 64, 64 * m, 128 * m, 256 * m, 512 * m)


class ResNetEncoder(nn.Module):
    def __init__(self, variant: str = 'resnet50'):
        super().__init__()
        block, layers = RESNETS[variant]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for idx, (n, width) in enumerate(zip(layers, (64, 128, 256, 512)), start=1):
            blocks = [block(inplanes, width, 1 if idx == 1 else 2)]
            inplanes = width * block.expansion
            blocks += [block(inplanes, width) for _ in range(1, n)]
            setattr(self, f'layer{idx}', nn.Sequential(*blocks))
        self.out_channels = resnet_out_channels(variant)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        x = self.relu(self.bn1(self.conv1(x)))
        feats.append(x)
        x = self.maxpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            feats.append(x)
        return feats
