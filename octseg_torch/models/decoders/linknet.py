"""LinkNet decoder: channel-reduced transposed-convolution blocks with
additive skips.

The port of octseg/models/decoders/linknet.py with SMP's module names:
``blocks.{i}.block.0`` a Conv2dReLU 1x1 to in/4, ``block.1`` TransposeX2
(``ConvTranspose2d(k=4, s=2, p=1, bias=False)``, BatchNorm, ReLU),
``block.2`` a Conv2dReLU 1x1 to the skip's width. The input is the deepest
feature, the skips ``features[4..1]`` are added after blocks 0-3, and block
4 ends at full resolution with 32 channels.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import BatchNorm2d, ConvBNAct, ConvTranspose2d
from octseg_torch.models.remat import RematBlock


class LinkNetDecoderBlock(RematBlock):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        mid = in_ch // 4
        self.block = nn.Sequential(
            ConvBNAct(in_ch, mid, 1),
            nn.Sequential(ConvTranspose2d(mid, mid, 4, 2, 1, bias=False),
                          BatchNorm2d(mid), nn.ReLU(inplace=True)),
            ConvBNAct(mid, out_ch, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class LinkNetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], prefinal_channels: int = 32):
        super().__init__()
        widths = list(encoder_channels[1:])[::-1] + [prefinal_channels]  # deepest first
        self.blocks = nn.ModuleList(
            [LinkNetDecoderBlock(widths[i], widths[i + 1]) for i in range(5)])

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x = features[5]
        for block, skip in zip(self.blocks, [features[4], features[3], features[2],
                                             features[1], None]):
            x = block(x)
            if skip is not None:
                x = x + skip
        return x
