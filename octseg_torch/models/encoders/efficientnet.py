"""EfficientNet encoders b0-b7 as a 6-level feature pyramid.

The port of octseg/models/encoders/efficientnet.py, with
efficientnet-pytorch's module names (the package SMP wraps for
``efficientnet-bX``): ``_conv_stem``/``_bn0``, then the flat
``_blocks.{i}._expand_conv/_bn0/_depthwise_conv/_bn1/_se_reduce/_se_expand
/_project_conv/_bn2``. Every convolution pads as XLA's SAME and every
BatchNorm has eps 1e-3, as in efficientnet-pytorch.

``forward(x) -> [x, f1, ..., f5]`` with f_i at spatial stride 2**i: the
stem, then the outputs of stages 1, 2, 4 and 6. Past ``output_stride`` a
stride-2 stage keeps stride 1 and doubles the dilation of the depthwise
convs of it and of every stage after it; their SAME padding uses the
dilated kernel (k-1)·d+1, as XLA's does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from octseg_torch.models.common import BatchNorm2d, Conv2d, Conv2dSame, squeeze_excite
from octseg_torch.models.remat import RematBlock

BN_EPS = 1e-3

# (expand_ratio, kernel, stride, out_channels, repeats): the b0 stages
_BASE_STAGES = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]

# variant -> (width multiplier, depth multiplier)
_SCALING = {
    'efficientnet-b0': (1.0, 1.0),
    'efficientnet-b1': (1.0, 1.1),
    'efficientnet-b2': (1.1, 1.2),
    'efficientnet-b3': (1.2, 1.4),
    'efficientnet-b4': (1.4, 1.8),
    'efficientnet-b5': (1.6, 2.2),
    'efficientnet-b6': (1.8, 2.6),
    'efficientnet-b7': (2.0, 3.1),
}

_TAP_STAGES = (1, 2, 4, 6)   # the last stage of each reduction level


def _round_channels(c: float, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def flattened_blocks(name: str) -> List[Dict[str, int]]:
    """Per-block arguments in the flat order of ``_blocks.{i}``:
    [{'stage', 'expand', 'kernel', 'stride', 'out'}]."""
    width_mult, depth_mult = _SCALING[name]
    out = []
    for stage, (expand, kernel, stride, out_c, repeats) in enumerate(_BASE_STAGES):
        out_c = _round_channels(out_c, width_mult)
        for block_idx in range(_round_repeats(repeats, depth_mult)):
            out.append({'stage': stage, 'expand': expand, 'kernel': kernel,
                        'stride': stride if block_idx == 0 else 1, 'out': out_c})
    return out


def efficientnet_out_channels(name: str) -> Sequence[int]:
    width_mult, _ = _SCALING[name]
    taps = [_round_channels(_BASE_STAGES[i][3], width_mult) for i in _TAP_STAGES]
    return (3, _round_channels(32, width_mult), *taps)


class MBConv(RematBlock):
    """Expand 1x1 (swish; none when expand = 1), depthwise kxk (swish),
    squeeze-excite on ``max(1, int(in * 0.25))`` channels (swish), project
    1x1 (no activation); the residual when stride = 1 and in = out."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int, stride: int,
                 dilation: int = 1):
        super().__init__()
        mid = in_ch * expand
        self.expand = expand != 1
        self.residual = stride == 1 and in_ch == out_ch
        if self.expand:
            self._expand_conv = Conv2dSame(in_ch, mid, 1)
            self._bn0 = BatchNorm2d(mid, eps=BN_EPS)
        self._depthwise_conv = Conv2dSame(mid, mid, kernel, stride, groups=mid,
                                          dilation=dilation)
        self._bn1 = BatchNorm2d(mid, eps=BN_EPS)
        reduced = max(1, int(in_ch * 0.25))
        self._se_reduce = Conv2d(mid, reduced, 1)
        self._se_expand = Conv2d(reduced, mid, 1)
        self._project_conv = Conv2dSame(mid, out_ch, 1)
        self._bn2 = BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self._bn0(self._expand_conv(x))) if self.expand else x
        y = F.silu(self._bn1(self._depthwise_conv(y)))
        y = squeeze_excite(y, self._se_reduce, self._se_expand, F.silu)
        y = self._bn2(self._project_conv(y))
        return y + x if self.residual else y


class EfficientNetEncoder(nn.Module):
    def __init__(self, variant: str = 'efficientnet-b0', output_stride: int = 32):
        super().__init__()
        self.out_channels = efficientnet_out_channels(variant)
        stem = self.out_channels[1]
        self._conv_stem = Conv2dSame(3, stem, 3, 2)
        self._bn0 = BatchNorm2d(stem, eps=BN_EPS)
        spec = flattened_blocks(variant)
        in_ch, blocks, self._taps = stem, [], set()
        current_stride, dilation = 2, 1
        for i, blk in enumerate(spec):
            stride = blk['stride']
            if stride == 2 and current_stride >= output_stride:
                stride, dilation = 1, dilation * 2
            elif stride == 2:
                current_stride *= 2
            blocks.append(MBConv(in_ch, blk['out'], blk['expand'], blk['kernel'], stride,
                                 dilation))
            in_ch = blk['out']
            last_of_stage = i + 1 == len(spec) or spec[i + 1]['stage'] != blk['stage']
            if last_of_stage and blk['stage'] in _TAP_STAGES:
                self._taps.add(i)
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = F.silu(self._bn0(self._conv_stem(x)))
        feats = [x, y]
        for i, block in enumerate(self._blocks):
            y = block(y)
            if i in self._taps:
                feats.append(y)
        return feats
