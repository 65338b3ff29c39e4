"""DeepLabV3 and DeepLabV3+ decoders (the port of
octseg/models/decoders/deeplab.py), with SMP's module names.

ASPP (``convs.0`` 1x1; ``convs.1-3`` 3x3 at rates 12, 24 and 36, dense or,
for V3+, SMP's SeparableConv2d; ``convs.4`` the pooling branch: spatial
mean, 1x1, broadcast back; every branch with BatchNorm and ReLU),
concatenated, ``project`` (1x1, BatchNorm, ReLU, elementwise dropout 0.5).

- DeepLabV3 (encoder at output stride 8): ``0`` ASPP, ``1`` a 3x3 conv,
  ``2`` BatchNorm, ``3`` ReLU; output at 1/8 (the head upsamples by 8).
- DeepLabV3Plus (output stride 16): ``aspp`` = (``0`` separable ASPP, ``1``
  a separable 3x3, ``2`` BatchNorm, ``3`` ReLU), upsampled to the 1/4 map
  with ``align_corners=True``; ``block1`` a 1x1 to 48 channels of the 1/4
  map; concatenated; ``block2`` a separable 3x3 with BatchNorm and ReLU;
  output at 1/4 (the head upsamples by 4).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import (BatchNorm2d, Conv2d, ConvBNAct, Dropout,
                                        SeparableConv2d, SeparableConvBNAct,
                                        resize_bilinear_torch)


class ASPPPooling(nn.Sequential):
    """``1`` conv, ``2`` BatchNorm (``0`` is SMP's AdaptiveAvgPool2d(1)); the
    pooled map is broadcast back, what a resize from one pixel gives."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), Conv2d(in_ch, out_ch, 1, bias=False),
                         BatchNorm2d(out_ch), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    def __init__(self, in_ch: int, out_ch: int = 256, rates: Sequence[int] = (12, 24, 36),
                 separable: bool = False):
        super().__init__()
        branches = [ConvBNAct(in_ch, out_ch, 1)]
        for rate in rates:
            branches.append(SeparableConvBNAct(in_ch, out_ch, rate) if separable
                            else ConvBNAct(in_ch, out_ch, 3, dilation=rate))
        branches.append(ASPPPooling(in_ch, out_ch))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(Conv2d(len(branches) * out_ch, out_ch, 1, bias=False),
                                     BatchNorm2d(out_ch), nn.ReLU(inplace=True), Dropout(0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([conv(x) for conv in self.convs], dim=1))


class DeepLabV3Decoder(nn.Sequential):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256):
        super().__init__(ASPP(encoder_channels[5], out_channels),
                         Conv2d(out_channels, out_channels, 3, 1, 1, bias=False),
                         BatchNorm2d(out_channels), nn.ReLU(inplace=True))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        return super().forward(features[5])


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256,
                 low_level_channels: int = 48):
        super().__init__()
        self.aspp = nn.Sequential(
            ASPP(encoder_channels[5], out_channels, separable=True),
            SeparableConv2d(out_channels, out_channels, 3),
            BatchNorm2d(out_channels), nn.ReLU(inplace=True))
        self.block1 = ConvBNAct(encoder_channels[2], low_level_channels, 1)
        self.block2 = SeparableConvBNAct(out_channels + low_level_channels, out_channels)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        low = features[2]
        x = resize_bilinear_torch(self.aspp(features[5]), low.shape[-2:], align_corners=True)
        return self.block2(torch.cat([x, self.block1(low)], dim=1))
