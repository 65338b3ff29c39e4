"""PAN decoder (the port of octseg/models/decoders/pan.py), with SMP's
module names; the encoder runs at output stride 16.

``fpa`` (Feature Pyramid Attention) on the deepest map: ``branch1`` global
mean, 1x1, broadcast back; ``mid`` a 1x1; a one-channel pyramid
(``down1`` 2x2 max pool and 7x7, ``down2`` pool and 5x5, ``down3`` pool and
two 3x3) merged bottom-up through the ``conv2`` (5x5) and ``conv1`` (7x7)
laterals with ``align_corners=True`` resizes; the attention map multiplies
``mid``, plus the global branch. Then ``gau3``/``gau2``/``gau1`` (Global
Attention Upsample) over the 1/16, 1/8 and 1/4 maps: the high-level map
resized to the skip, plus ``conv2`` (3x3) of the skip gated by the sigmoid of
``conv1`` (1x1, no ReLU) of the pooled high-level map. Every ConvBnRelu conv
has a bias. Output at 1/4 with 32 channels (the head upsamples by 4).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from octseg_torch.models.common import ConvBNAct, resize_bilinear_torch


class ConvBnRelu(ConvBNAct):
    """SMP PAN's ConvBnRelu: children ``conv`` (with bias) and ``bn``."""

    NAMES = ('conv', 'bn', 'act')

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, add_relu: bool = True):
        super().__init__(in_ch, out_ch, kernel, act=add_relu, bias=True)


def _pooled(module: nn.Module) -> nn.Sequential:
    """SMP's ``Sequential(AdaptiveAvgPool2d(1), module)``: ``module`` is ``1``."""
    return nn.Sequential(nn.AdaptiveAvgPool2d(1), module)


def _maxpooled(*modules: nn.Module) -> nn.Sequential:
    return nn.Sequential(nn.MaxPool2d(2, 2), *modules)


class FPABlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.branch1 = _pooled(ConvBnRelu(in_ch, out_ch, 1))
        self.mid = nn.Sequential(ConvBnRelu(in_ch, out_ch, 1))
        self.down1 = _maxpooled(ConvBnRelu(in_ch, 1, 7))
        self.down2 = _maxpooled(ConvBnRelu(1, 1, 5))
        self.down3 = _maxpooled(ConvBnRelu(1, 1, 3), ConvBnRelu(1, 1, 3))
        self.conv2 = ConvBnRelu(1, 1, 5)
        self.conv1 = ConvBnRelu(1, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        b1 = self.branch1(x).expand(-1, -1, h, w)
        mid = self.mid(x)
        x1 = self.down1(x)
        x2 = self.down2(x1)
        x3 = resize_bilinear_torch(self.down3(x2), (h // 4, w // 4), align_corners=True)
        a = resize_bilinear_torch(self.conv2(x2) + x3, (h // 2, w // 2), align_corners=True)
        a = resize_bilinear_torch(a + self.conv1(x1), (h, w), align_corners=True)
        return a * mid + b1


class GAUBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = _pooled(ConvBnRelu(out_ch, out_ch, 1, add_relu=False))
        self.conv2 = ConvBnRelu(in_ch, out_ch, 3)

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.conv1(high))
        up = resize_bilinear_torch(high, low.shape[-2:], align_corners=True)
        return up + self.conv2(low) * gate


class PANDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], decoder_channels: int = 32):
        super().__init__()
        self.fpa = FPABlock(encoder_channels[5], decoder_channels)
        self.gau3 = GAUBlock(encoder_channels[4], decoder_channels)
        self.gau2 = GAUBlock(encoder_channels[3], decoder_channels)
        self.gau1 = GAUBlock(encoder_channels[2], decoder_channels)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x = self.fpa(features[5])
        x = self.gau3(x, features[4])
        x = self.gau2(x, features[3])
        return self.gau1(x, features[2])
