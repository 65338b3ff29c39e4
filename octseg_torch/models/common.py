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
pixel after, computed from the input size and the effective kernel
(k-1)·d+1 at each call.

``resize_bilinear_torch`` is octseg's torch-semantics bilinear resize (the
decoders' ``align_corners`` resizes and the head's upsampling), torch's
``F.interpolate`` in float32; ``GroupNorm`` computes in float32
with torch's eps 1e-5. ``Dropout`` and ``Dropout2d`` draw their masks from a
``torch.Generator`` the caller hands over (``set_dropout_generator``), never
from the global RNG.

Compute dtype (octseg's ``dtype``, set by ``set_compute_dtype``): with
bfloat16, every convolution casts its input, weight and bias to bfloat16 at
use and returns bfloat16, as flax's ``nn.Conv(dtype=bfloat16)`` does, and
every BatchNorm computes in float32 and returns its input's dtype, as
flax's ``nn.BatchNorm(dtype=bfloat16)`` does; parameters and running
statistics stay float32. In training, a BatchNorm that runs again while a
checkpointed block is recomputed in the backward (models/remat.py) leaves
its running statistics alone: they move once per step, as in flax, whose
recomputation is functional.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from octseg_torch.models.remat import recomputing


class BatchNorm2d(nn.BatchNorm2d):
    # flax's momentum 0.9 is the weight of the old running value
    FLAX_MOMENTUM = 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a bfloat16 input takes torch's mixed-type kernel: float32 statistics
        # and arithmetic with the float32 parameters, one rounding to
        # bfloat16 at the output, and no float32 copy of the activations
        if not self.training:
            return super().forward(x)
        # torch.batch_norm, not F.batch_norm: a pooled 1x1 map of one sample
        # normalises to its bias, as in flax, where F.batch_norm raises
        y = torch.batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps,
                             torch.backends.cudnn.enabled)
        if not recomputing():
            with torch.no_grad():
                # float32 statistics of a bfloat16 input (no copy for float32)
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
                m = self.FLAX_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        return y


class _ComputeDtype:
    """Mixin of the convolutions: ``compute_dtype`` None computes in the
    parameters' dtype; a dtype casts input, weight and bias to it at use."""

    compute_dtype: Optional[torch.dtype] = None

    def cast(self, x: torch.Tensor):
        """(input, weight, bias) in the compute dtype."""
        dt = self.compute_dtype
        if dt is None:
            return x, self.weight, self.bias
        return x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt)


class Conv2d(_ComputeDtype, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*self.cast(x))


class ConvTranspose2d(_ComputeDtype, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self.cast(x)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every convolution of ``model`` computes in ``dtype`` (float32: in
    its parameters' dtype). Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, _ComputeDtype):
            mod.compute_dtype = None if dtype == torch.float32 else dtype
    return model


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(before, after) of XLA's SAME padding along one axis."""
    total = max((-(-size // stride) - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(Conv2d):
    """nn.Conv2d with XLA SAME padding. Symmetric cases (every stride-1 odd
    kernel) pass the padding to the convolution; asymmetric ones (stride 2
    over an even size) pad the input first."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dilation: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, 0, dilation, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_padding(size, k, s, d) for size, k, s, d in
            zip(x.shape[-2:], self.kernel_size, self.stride, self.dilation))
        x, w, b = self.cast(x)
        if top == bottom and left == right:
            return F.conv2d(x, w, b, self.stride, (top, left), self.dilation, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, b, self.stride, 0, self.dilation, self.groups)


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> ReLU with torch padding ``dilation*(k-1)//2``.

    Children are named by ``NAMES``: SMP's ``Conv2dReLU`` (``0`` conv, ``1``
    bn, ``2`` relu); timm's ConvNormAct subclasses it with ``conv`` /
    ``bn``. ``bias`` gives the conv a bias; ``bn=False`` puts an identity
    where the BatchNorm was and a bias on the conv (SMP's Conv2dReLU without
    batchnorm)."""

    NAMES: Sequence[str] = ('0', '1', '2')

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, act: bool = True, groups: int = 1, bias: bool = False,
                 bn: bool = True):
        pad = dilation * (kernel - 1) // 2
        layers = [Conv2d(in_ch, out_ch, kernel, stride, pad, dilation, groups=groups,
                         bias=bias or not bn),
                  BatchNorm2d(out_ch) if bn else nn.Identity()]
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
        self.fc1 = Conv2d(channels, reduced, 1)
        self.fc2 = Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.fc1, self.fc2, F.relu)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (each pixel repeated 2x2, octseg common.upsample)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def resize_bilinear_torch(x: torch.Tensor, size: Sequence[int],
                          align_corners: bool = True) -> torch.Tensor:
    """NCHW bilinear resize to ``size`` with torch's non-antialiased
    semantics, as octseg's ``resize_bilinear_torch`` (which builds them as
    float32 interpolation matrices): computed in float32 and returned in
    ``x``'s dtype."""
    return F.interpolate(x.float(), size=(int(size[0]), int(size[1])), mode='bilinear',
                         align_corners=align_corners).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """torch's GroupNorm (eps 1e-5, as octseg pins flax's) computed in
    float32 and returned in the input's dtype, as flax's
    ``nn.GroupNorm(dtype=bfloat16)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class SeparableConv2d(nn.Sequential):
    """SMP's SeparableConv2d: ``0`` a depthwise kxk conv (dilated, torch
    padding), ``1`` a pointwise 1x1 conv, both without bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dilation: int = 1):
        super().__init__(
            Conv2d(in_ch, in_ch, kernel, 1, dilation * (kernel - 1) // 2, dilation,
                   groups=in_ch, bias=False),
            Conv2d(in_ch, out_ch, 1, bias=False))


class SeparableConvBNAct(nn.Sequential):
    """``0`` SeparableConv2d, ``1`` BatchNorm, ``2`` ReLU (SMP's
    ASPPSeparableConv and the DeepLabV3+ blocks)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1):
        super().__init__(SeparableConv2d(in_ch, out_ch, 3, dilation), BatchNorm2d(out_ch),
                         nn.ReLU(inplace=True))


class _Dropout(nn.Module):
    """Dropout with probability ``p`` in train mode, drawn from
    ``self.generator`` (set by ``set_dropout_generator``); kept values are
    scaled by 1/(1-p), as flax's ``nn.Dropout`` does. Identity in eval
    mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError('dropout in train mode needs a generator: '
                               'models.common.set_dropout_generator(model, generator)')
        keep = torch.rand(self.mask_shape(x), generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))

    def extra_repr(self) -> str:
        return f'p={self.p}'


class Dropout(_Dropout):
    """Elementwise dropout (torch's nn.Dropout; SMP's ASPP, 0.5)."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)


class Dropout2d(_Dropout):
    """Whole-channel dropout (torch's nn.Dropout2d; SMP's FPN and PSPNet,
    0.2): one draw per (sample, channel), broadcast over H and W."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape[:2]) + (1, 1)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]
                          ) -> nn.Module:
    """Every dropout of ``model`` draws from ``generator``. Returns it."""
    for mod in model.modules():
        if isinstance(mod, _Dropout):
            mod.generator = generator
    return model
