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

``Conv2dSame`` pads as XLA's ``padding='SAME'`` (TF SAME, what
efficientnet-pytorch's Conv2dStaticSamePadding does): asymmetric, the odd
pixel after, computed from the input size at each call.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Sequence, Tuple

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


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(before, after) of XLA's SAME padding along one axis."""
    total = max((-(-size // stride) - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """nn.Conv2d with XLA SAME padding. Symmetric cases (every stride-1 odd
    kernel) pass the padding to the convolution; asymmetric ones (stride 2
    over an even size) pad the input first."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride, 0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_padding(size, k, s, d) for size, k, s, d in
            zip(x.shape[-2:], self.kernel_size, self.stride, self.dilation))
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left),
                            self.dilation, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> ReLU with torch padding ``dilation*(k-1)//2``.

    Children are named by ``NAMES``: SMP's ``Conv2dReLU`` (``0`` conv, ``1``
    bn, ``2`` relu); timm's ConvNormAct subclasses it with ``conv`` /
    ``bn``."""

    NAMES: Sequence[str] = ('0', '1', '2')

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, act: bool = True, groups: int = 1):
        pad = dilation * (kernel - 1) // 2
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, dilation, groups=groups,
                            bias=False),
                  BatchNorm2d(out_ch)]
        if act:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(OrderedDict(zip(self.NAMES, layers)))


def squeeze_excite(x: torch.Tensor, reduce: nn.Module, expand: nn.Module,
                   act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Squeeze-and-excitation gate (octseg common.SqueezeExcite): spatial
    mean, 1x1 conv with bias, ``act``, 1x1 conv with bias, sigmoid."""
    s = x.mean(dim=(2, 3), keepdim=True)
    return x * torch.sigmoid(expand(act(reduce(s))))


class SqueezeExcite(nn.Module):
    """timm's SEModule (relu): children ``fc1`` and ``fc2``."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, reduced, 1)
        self.fc2 = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.fc1, self.fc2, F.relu)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (each pixel repeated 2x2, octseg common.upsample)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
