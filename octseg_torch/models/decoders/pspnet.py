"""PSPNet decoder (the port of octseg/models/decoders/pspnet.py), with SMP's
module names.

It reads ``features[3]`` (SMP's encoder depth 3, the map at 1/8; the deeper
stages still run, as in octseg, so their BatchNorm statistics move in
training). ``psp.blocks.{i}.pool``: an adaptive average pool to 1, 2, 3 and 6
bins (torch's bin edges, which are octseg's) and a 1x1 ``Conv2dReLU`` to
in/4 channels, with BatchNorm except the 1-bin branch, whose conv has a bias
instead; each branch resized back with ``align_corners=True``; concatenated
with the input, ``conv`` (1x1 to 512, BatchNorm, ReLU), whole-channel
dropout 0.2. Output at 1/8 (the head upsamples by 8).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import ConvBNAct, Dropout2d, resize_bilinear_torch


class PSPBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bins: int):
        super().__init__()
        self.pool = nn.Sequential(nn.AdaptiveAvgPool2d(bins),
                                  ConvBNAct(in_ch, out_ch, 1, bn=bins != 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear_torch(self.pool(x), x.shape[-2:], align_corners=True)


class PSPModule(nn.Module):
    def __init__(self, in_ch: int, bins: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.blocks = nn.ModuleList([PSPBlock(in_ch, in_ch // len(bins), b) for b in bins])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([block(x) for block in self.blocks] + [x], dim=1)


class PSPDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 512,
                 dropout: float = 0.2):
        super().__init__()
        c = encoder_channels[3]
        self.psp = PSPModule(c)
        self.conv = ConvBNAct(c * 2, out_channels, 1)
        self.dropout = Dropout2d(dropout)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        return self.dropout(self.conv(self.psp(features[3])))
