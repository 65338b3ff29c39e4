"""int8 inference: the port of octseg/ops/quantize.py.

Under ``int8_conv_mode()`` every eligible convolution of a port model runs
octseg's int8 path (models/common.py's ``Conv2d`` and ``Conv2dSame`` call
``quantized_conv``):

- activations: one scale per tensor, over the whole batch, computed afresh
  at every call, ``sa = max(max |x|, 1e-8)``, and
  ``xq = clip(round_half_even(x * (127 / sa)), -127, 127)`` (K5,
  ops/kernels/quantize.py);
- weights: one scale per output channel, ``sw = max(max over (kh, kw, cin)
  |w|, 1e-8)``, quantized from the float32 parameter even when the model
  computes in bfloat16; computed once and cached on the module (inference
  does not change the parameters; a changed or moved parameter is
  quantized again);
- the convolution: int8 x int8 -> int32 with the module's stride, dilation
  and padding, then ``float32(acc) * ((sa * sw) / (127 * 127)) (+ bias)``
  in float32, cast to the module's compute dtype or the input's (K4,
  ops/kernels/int8_conv.py).

Eligible (octseg's ``_eligible``): a convolution that is the counterpart of a
flax ``nn.Conv`` (the port's ``Conv2d`` and ``Conv2dSame``; never
``ConvTranspose2d``), with one group and ``kh * kw * cin * cout >=
MIN_MACS``.

Because the activation scale spans the batch, an int8 result depends on
which frames share a forward.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
from torch import nn

from octseg_torch.ops.kernels.int8_conv import Pads, int8_conv2d
from octseg_torch.ops.kernels.quantize import quantize_activation

# octseg's threshold: below it a convolution is left exact
MIN_MACS = 64 * 64 * 9

_mode = threading.local()


def eligible(conv: nn.Module) -> bool:
    """Whether ``conv`` runs the int8 path under ``int8_conv_mode()``."""
    if not isinstance(conv, nn.Conv2d) or conv.groups != 1:
        return False
    cout, cin, kh, kw = conv.weight.shape
    return kh * kw * cin * cout >= MIN_MACS


def quantize_weight(weight: torch.Tensor, channels: int = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wq int8 (Cout, kh, kw, channels), sw float32 (Cout,)) of a float32
    (Cout, Cin, kh, kw) weight; channels beyond Cin are zero."""
    w = weight.detach().float()
    sw = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8)
    wq = torch.round(w * divide(127.0, sw).view(-1, 1, 1, 1)).clamp(-127, 127).to(torch.int8)
    wq = wq.permute(0, 2, 3, 1)
    cin = weight.shape[1]
    if channels is not None and channels != cin:
        wq = torch.cat([wq, wq.new_zeros((*wq.shape[:3], channels - cin))], dim=3)
    return wq.contiguous(), sw


def divide(a, b):
    """``a / b`` correctly rounded in float32, for Python floats or float32
    tensors on one device. torch computes ``float / tensor`` as
    ``reciprocal(tensor) * float``, and on CUDA ``tensor / float`` as
    ``tensor * (1 / float)``: either may differ from the quotient by an ulp."""
    ref = b if isinstance(b, torch.Tensor) else a
    a, b = (v if isinstance(v, torch.Tensor) else ref.new_full((), v) for v in (a, b))
    return torch.div(a, b)


def padded_channels(c: int) -> int:
    """The channel count the int8 kernels take: C rounded up to 8."""
    return -(-c // 8) * 8


def _weights(conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The module's (wq, sw), cached against the parameter's storage and
    version."""
    w = conv.weight
    try:
        version = w._version
    except RuntimeError:   # an inference tensor has no version counter
        version = None
    key = (w.data_ptr(), version, w.device)
    cached = getattr(conv, '_int8_weights', None)
    if cached is None or cached[0] != key:
        cached = (key, quantize_weight(w, padded_channels(w.shape[1])))
        conv._int8_weights = cached
    return cached[1]


def quantized_conv(conv: nn.Conv2d, x: torch.Tensor, pads: Pads) -> torch.Tensor:
    """The int8 path for one call of an eligible ``conv`` on NCHW ``x``,
    padded by ``pads`` ((top, bottom), (left, right))."""
    wq, sw = _weights(conv)
    xq, sa = quantize_activation(x, wq.shape[3])
    scale = divide(sa * sw, 127.0 * 127.0)
    bias = None if conv.bias is None else conv.bias.detach().float()
    out_dtype = conv.compute_dtype or x.dtype
    return int8_conv2d(xq, wq, scale, bias, conv.stride, pads, conv.dilation, out_dtype)


def int8_active() -> bool:
    """Whether this thread is inside ``int8_conv_mode()``."""
    return getattr(_mode, 'on', False)


@contextlib.contextmanager
def int8_conv_mode():
    """Every eligible convolution called in this thread inside the block
    runs the int8 path."""
    prev = int8_active()
    _mode.on = True
    try:
        yield
    finally:
        _mode.on = prev


def apply_int8(model: nn.Module, x: torch.Tensor, *args, **kwargs):
    """``model(x, ...)`` with int8 convolutions."""
    with int8_conv_mode():
        return model(x, *args, **kwargs)
