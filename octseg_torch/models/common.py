"""Shared NCHW building blocks (the port of octseg/models/common.py).

Submodules are named as segmentation_models_pytorch names them, so a port
model's ``state_dict`` is an SMP state dict (models/convert.py maps it to
and from the JAX package's flax tree).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> ReLU with torch padding ``dilation*(k-1)//2``
    (SMP ``Conv2dReLU``: children ``0`` conv, ``1`` bn, ``2`` relu)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        pad = dilation * (kernel - 1) // 2
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, dilation,
                            bias=False),
                  nn.BatchNorm2d(out_ch)]
        if act:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (each pixel repeated 2x2, octseg common.upsample)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
