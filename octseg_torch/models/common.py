"""Shared NCHW building blocks (the port of octseg/models/common.py).

Submodules are named as segmentation_models_pytorch names them, so a port
model's ``state_dict`` is an SMP state dict (models/convert.py maps it to
and from the JAX package's flax tree).

``BatchNorm2d`` trains as flax's ``nn.BatchNorm(momentum=0.9)`` does in
octseg: it normalises with the batch statistics and moves the running
statistics by 0.1 towards the batch mean and the BIASED batch variance
(torch's own BatchNorm2d moves them towards the unbiased variance, n/(n-1)
larger). In eval mode it is torch's BatchNorm2d, running statistics
untouched. Flax computes the variance as E[x^2] - E[x]^2; this layer as
E[(x - E[x])^2], which differs in rounding only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    # flax's momentum 0.9 is the weight of the old running value
    FLAX_MOMENTUM = 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        return y


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> ReLU with torch padding ``dilation*(k-1)//2``
    (SMP ``Conv2dReLU``: children ``0`` conv, ``1`` bn, ``2`` relu)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        pad = dilation * (kernel - 1) // 2
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, dilation,
                            bias=False),
                  BatchNorm2d(out_ch)]
        if act:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (each pixel repeated 2x2, octseg common.upsample)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
