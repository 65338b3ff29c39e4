"""MA-Net decoder (the port of octseg/models/decoders/manet.py), with SMP's
module names.

``center`` (PAB, position attention on the deepest map): 1x1 ``top_conv``
and ``center_conv`` to 64 channels and 3x3 ``bottom_conv`` and
``out_conv`` keeping the width, all with a bias; the softmax runs over the
flattened (hw x hw) map, not per row, and the attended (b, hw, c) product is
reshaped to (b, c, h, w) without a transpose: SMP's two quirks, which
trained weights bake in. Then ``blocks.0-3`` (MFAB): ``hl_conv`` (3x3, then
1x1 to the skip's width), nearest x2, SE gates ``SE_hl`` on it and ``SE_ll``
on the skip (pool, 1x1 to width/16, ReLU, 1x1, sigmoid) summed, the
gated map concatenated with the skip, two 3x3 ``Conv2dReLU``; ``blocks.4`` a
plain U-Net block (nearest x2, two 3x3). Output at full resolution, 16
channels.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import Conv2d, ConvBNAct, upsample2x
from octseg_torch.models.decoders.unet import DecoderBlock


class PABlock(nn.Module):
    def __init__(self, in_ch: int, pab_channels: int = 64):
        super().__init__()
        self.top_conv = Conv2d(in_ch, pab_channels, 1)
        self.center_conv = Conv2d(in_ch, pab_channels, 1)
        self.bottom_conv = Conv2d(in_ch, in_ch, 3, 1, 1)
        self.out_conv = Conv2d(in_ch, in_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        top = self.top_conv(x).flatten(2)                      # (n, pab, hw)
        center = self.center_conv(x).flatten(2).transpose(1, 2)  # (n, hw, pab)
        bottom = self.bottom_conv(x).flatten(2).transpose(1, 2)  # (n, hw, c)
        # float32 products of the compute-dtype operands, as octseg's einsums
        # with preferred_element_type=float32
        logits = torch.bmm(center.float(), top.float())
        attention = torch.softmax(logits.view(n, -1), dim=-1).view(n, h * w, h * w)
        y = torch.bmm(attention.to(bottom.dtype).float(), bottom.float()).to(x.dtype)
        return self.out_conv(x + y.reshape(n, c, h, w))


def _se(channels: int, reduced: int) -> nn.Sequential:
    return nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv2d(channels, reduced, 1),
                         nn.ReLU(inplace=True), Conv2d(reduced, channels, 1), nn.Sigmoid())


class MFABlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, reduction: int = 16):
        super().__init__()
        reduced = max(1, skip_ch // reduction)
        self.hl_conv = nn.Sequential(ConvBNAct(in_ch, in_ch, 3), ConvBNAct(in_ch, skip_ch, 1))
        self.SE_ll = _se(skip_ch, reduced)
        self.SE_hl = _se(skip_ch, reduced)
        self.conv1 = ConvBNAct(2 * skip_ch, out_ch, 3)
        self.conv2 = ConvBNAct(out_ch, out_ch, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = upsample2x(self.hl_conv(x))
        x = x * (self.SE_hl(x) + self.SE_ll(skip))
        return self.conv2(self.conv1(torch.cat([x, skip], dim=1)))


class MAnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 reduction: int = 16, pab_channels: int = 64):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]   # deepest first
        self.center = PABlock(enc[0], pab_channels)
        in_ch = [enc[0]] + list(decoder_channels[:-1])
        blocks = [MFABlock(i, s, o, reduction)
                  for i, s, o in zip(in_ch[:4], enc[1:], decoder_channels[:4])]
        blocks.append(DecoderBlock(in_ch[4], decoder_channels[4]))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x = self.center(features[5])
        for block, skip in zip(self.blocks[:4], (features[4], features[3], features[2],
                                                 features[1])):
            x = block(x, skip)
        return self.blocks[4](x)
