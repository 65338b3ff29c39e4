"""RegNetX/Y encoders as a 6-level feature pyramid.

The port of octseg/models/encoders/regnet.py at output stride 32, with
timm's module names: ``stem.conv/stem.bn``, then
``s{k}.b{j}.conv{1,2,3}.{conv,bn}``, ``se.fc1/fc2`` (Y variants) and
``downsample.{conv,bn}``.

``forward(x) -> [x, f1, ..., f5]``: the stem (32 channels, 3x3, stride 2),
then the four stages, each halving the resolution.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from octseg_torch.models.common import ConvBNAct, SqueezeExcite
from octseg_torch.models.remat import RematBlock

# name -> stage widths, depths, group width, squeeze-excite
_CONFIGS = {
    'timm-regnetx_002': dict(widths=(24, 56, 152, 368), depths=(1, 1, 4, 7), group=8, se=False),
    'timm-regnetx_064': dict(widths=(168, 392, 784, 1624), depths=(1, 3, 7, 6), group=56,
                             se=False),
    'timm-regnety_120': dict(widths=(224, 448, 896, 2240), depths=(2, 5, 11, 1), group=112,
                             se=True),
}

_STEM_WIDTH = 32


def regnet_out_channels(name: str) -> Sequence[int]:
    return (3, _STEM_WIDTH) + tuple(_CONFIGS[name]['widths'])


class ConvNormAct(ConvBNAct):
    """timm's ConvNormAct: children ``conv`` and ``bn``."""

    NAMES = ('conv', 'bn', 'act')


class RegNetBlock(RematBlock):
    """1x1, 3x3 grouped (``width // group_width`` groups), squeeze-excite on
    ``se_in // 4`` channels for the Y variants, 1x1 with no activation; a
    strided 1x1 downsample where the shapes differ; relu after the sum."""

    def __init__(self, in_ch: int, width: int, stride: int, group_width: int, se: bool,
                 se_in: int):
        super().__init__()
        self.conv1 = ConvNormAct(in_ch, width, 1)
        self.conv2 = ConvNormAct(width, width, 3, stride, groups=max(width // group_width, 1))
        self.se = SqueezeExcite(width, max(se_in // 4, 1)) if se else None
        self.conv3 = ConvNormAct(width, width, 1, act=False)
        self.downsample = (ConvNormAct(in_ch, width, 1, stride, act=False)
                           if stride != 1 or in_ch != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y)
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class RegNetEncoder(nn.Module):
    def __init__(self, variant: str = 'timm-regnetx_002'):
        super().__init__()
        cfg = _CONFIGS[variant]
        self.stem = ConvNormAct(3, _STEM_WIDTH, 3, 2)
        in_ch = _STEM_WIDTH
        for k, (width, depth) in enumerate(zip(cfg['widths'], cfg['depths']), start=1):
            blocks = OrderedDict()
            for j in range(1, depth + 1):
                # the SE width is the block input's: the stage input for b1
                blocks[f'b{j}'] = RegNetBlock(in_ch, width, 2 if j == 1 else 1, cfg['group'],
                                              cfg['se'], in_ch)
                in_ch = width
            setattr(self, f's{k}', nn.Sequential(blocks))
        self.out_channels = regnet_out_channels(variant)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = self.stem(x)
        feats = [x, y]
        for stage in (self.s1, self.s2, self.s3, self.s4):
            y = stage(y)
            feats.append(y)
        return feats
