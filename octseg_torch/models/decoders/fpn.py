"""FPN decoder (the port of octseg/models/decoders/fpn.py), with SMP's
module names.

``p5`` a 1x1 lateral conv of the deepest map; ``p4``/``p3``/``p2`` FPN
blocks, each a nearest x2 upsample of the level above plus its
``skip_conv`` (1x1, bias) of the encoder map; four ``seg_blocks`` of
``Conv3x3GNReLU`` (``block.{j}.block``: conv without bias, GroupNorm(32),
ReLU) with 3, 2, 1 and 0 nearest x2 upsamples, one after each conv; merged
by sum; whole-channel dropout 0.2. Output at 1/4 (the head upsamples by 4).
The upsamples are nearest, as octseg's (SMP's Conv3x3GNReLU upsamples
bilinearly).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import Conv2d, Dropout2d, GroupNorm, upsample2x


class FPNBlock(nn.Module):
    def __init__(self, pyramid_ch: int, skip_ch: int):
        super().__init__()
        self.skip_conv = Conv2d(skip_ch, pyramid_ch, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return upsample2x(x) + self.skip_conv(skip)


class Conv3x3GNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: bool):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(Conv2d(in_ch, out_ch, 3, 1, 1, bias=False),
                                   GroupNorm(32, out_ch, eps=1e-5), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block(x)
        return upsample2x(x) if self.upsample else x


class SegmentationBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_upsamples: int):
        super().__init__()
        blocks = [Conv3x3GNReLU(in_ch, out_ch, n_upsamples > 0)]
        blocks += [Conv3x3GNReLU(out_ch, out_ch, True) for _ in range(1, n_upsamples)]
        self.block = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FPNDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dropout: float = 0.2):
        super().__init__()
        c2, c3, c4, c5 = encoder_channels[2:6]
        self.p5 = Conv2d(c5, pyramid_channels, 1)
        self.p4 = FPNBlock(pyramid_channels, c4)
        self.p3 = FPNBlock(pyramid_channels, c3)
        self.p2 = FPNBlock(pyramid_channels, c2)
        self.seg_blocks = nn.ModuleList(
            [SegmentationBlock(pyramid_channels, segmentation_channels, n)
             for n in (3, 2, 1, 0)])
        self.dropout = Dropout2d(dropout)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        p5 = self.p5(features[5])
        p4 = self.p4(p5, features[4])
        p3 = self.p3(p4, features[3])
        p2 = self.p2(p3, features[2])
        x = sum(block(p) for block, p in zip(self.seg_blocks, (p5, p4, p3, p2)))
        return self.dropout(x)
