"""U-Net and U-Net++ decoders over the 6-level encoder pyramid.

The port of octseg/models/decoders/unet.py (no attention variant), with
SMP's module names: Unet ``blocks.{i}.conv{1,2}``; UNet++
``blocks.x_{d}_{l}.conv{1,2}`` where grid node (level i, column j) is
``x_{4-i-j}_{3-i}`` and the full-resolution block is ``x_0_4``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import ConvBNAct, upsample2x
from octseg_torch.models.remat import RematBlock


class DecoderBlock(RematBlock):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, out_ch, 3)
        self.conv2 = ConvBNAct(out_ch, out_ch, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor = None) -> torch.Tensor:
        x = upsample2x(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first
        in_ch = [enc[0]] + list(decoder_channels[:-1])
        skip_ch = enc[1:] + [0]
        self.blocks = nn.ModuleList(
            [DecoderBlock(i + s, o)
             for i, s, o in zip(in_ch, skip_ch, decoder_channels)])

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        # features: [f0, f1 (1/2), ..., f5 (1/32)]
        x = features[5]
        skips = [features[4], features[3], features[2], features[1], None]
        for block, skip in zip(self.blocks, skips):
            x = block(x, skip)
        return x


class UnetPlusPlusDecoder(nn.Module):
    """Nested dense-skip grid. Nodes on the last column of each level output
    ``decoder_channels[3-i]``, the others the encoder width of their level;
    each node concatenates [upsampled node below, columns j-1..0 of its
    level] (SMP's channel policy and concat order)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        enc = list(encoder_channels[1:])  # f1..f5
        dec = list(decoder_channels)

        def node_out(i, j):
            return dec[3 - i] if j == 4 - i else enc[i]

        blocks = {}
        for j in range(1, 5):
            for i in range(0, 5 - j):
                below = enc[i + 1] if j == 1 else node_out(i + 1, j - 1)
                blocks[f'x_{4 - i - j}_{3 - i}'] = DecoderBlock(
                    below + j * enc[i], node_out(i, j))
        blocks['x_0_4'] = DecoderBlock(dec[3], dec[4])
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        grid = {(i, 0): features[i + 1] for i in range(5)}
        for j in range(1, 5):
            for i in range(0, 5 - j):
                skip = torch.cat([grid[(i, k)] for k in range(j - 1, -1, -1)], dim=1)
                grid[(i, j)] = self.blocks[f'x_{4 - i - j}_{3 - i}'](
                    grid[(i + 1, j - 1)], skip)
        return self.blocks['x_0_4'](grid[(0, 4)])
