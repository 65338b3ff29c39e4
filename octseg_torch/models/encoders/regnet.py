"""RegNetX/Y encoders as a 6-level feature pyramid.

The port of octseg/models/encoders/regnet.py, with timm's module names: ``stem.conv/stem.bn``, then
``s{k}.b{j}.conv{1,2,3}.{conv,bn}``, ``se.fc1/fc2`` (Y variants) and
``downsample.{conv,bn}``.

``forward(x) -> [x, f1, ..., f5]``: the stem (32 channels, 3x3, stride 2),
then the four stages, each halving the resolution until ``output_stride``;
past it a stage keeps stride 1 and doubles the dilation of its grouped 3x3
convs (every block of it, and of the stages after it).
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
                 se_in: int, dilation: int = 1):
        super().__init__()
        self.conv1 = ConvNormAct(in_ch, width, 1)
        self.conv2 = ConvNormAct(width, width, 3, stride, dilation,
                                 groups=max(width // group_width, 1))
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
    def __init__(self, variant: str = 'timm-regnetx_002', output_stride: int = 32):
        super().__init__()
        cfg = _CONFIGS[variant]
        self.stem = ConvNormAct(3, _STEM_WIDTH, 3, 2)
        in_ch, current_stride, dilation = _STEM_WIDTH, 2, 1
        for k, (width, depth) in enumerate(zip(cfg['widths'], cfg['depths']), start=1):
            stride = 2
            if current_stride >= output_stride:
                stride, dilation = 1, dilation * 2
            else:
                current_stride *= 2
            blocks = OrderedDict()
            for j in range(1, depth + 1):
                # the SE width is the block input's: the stage input for b1
                blocks[f'b{j}'] = RegNetBlock(in_ch, width, stride if j == 1 else 1,
                                              cfg['group'], cfg['se'], in_ch, dilation)
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
