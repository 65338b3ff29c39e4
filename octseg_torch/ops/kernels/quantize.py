"""Activation quantization of the int8 path (K5): the CUDA kernel and its
plain version.

Replaces no Pallas kernel: octseg leaves it to XLA's fusion
(octseg/ops/quantize.py ``quantized_conv``, :59-62). For one float32 or
bfloat16 NCHW tensor ``x`` it returns ``(xq, sa)``:

    sa = max(max |x| as float32, 1e-8)                  (0-dim float32)
    xq = clip(round_half_even(float32(x) * (127 / sa)), -127, 127)

``xq`` int8 NHWC ``(B, H, W, channels)``, the channels beyond C zero (the
int8 convolution kernel reads whole 8-byte groups of channels).

``quantize_activation_plain`` is the plain torch version, what the CPU runs
and what the kernel is held against on the card. The kernel is
``csrc/quantize.cu``: two passes (abs-max by atomicMax on the float's bits,
then quantize and transpose through shared memory), memory-bound; ``sa``
stays on the device.

``quantize_activation`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, on the current stream, without
synchronising. ``launches`` counts the kernel launches (one per call: both
passes).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

launches = 0


def quantize_activation_plain(x: torch.Tensor, channels: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch (xq NHWC int8, sa 0-dim float32) of NCHW ``x``."""
    sa = x.abs().amax().float().clamp_min(1e-8)
    # 127 / sa as one rounded division (torch's float / tensor is a
    # reciprocal and a product)
    xq = torch.round(x.float() * torch.div(sa.new_full((), 127.0), sa))
    xq = xq.clamp(-127, 127).to(torch.int8)
    xq = xq.permute(0, 2, 3, 1)
    c = x.shape[1]
    if channels is not None and channels != c:
        xq = torch.cat([xq, xq.new_zeros((*xq.shape[:3], channels - c))], dim=3)
    return xq.contiguous(), sa


def _library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load('quantize')
    fn = lib.octseg_quantize_activation
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def quantize_activation(x: torch.Tensor, channels: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, sa) of the NCHW float32 or bfloat16 ``x``; ``channels`` (at
    least C, default C) is the channel count of ``xq``."""
    global launches
    if x.ndim != 4:
        raise ValueError(f'x must be (B, C, H, W), got {tuple(x.shape)}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    b, c, h, w = x.shape
    channels = c if channels is None else int(channels)
    if channels < c:
        raise ValueError(f'channels {channels} < the input channels {c}')
    if x.numel() == 0:
        raise ValueError('an empty tensor has no scale')
    if x.device.type == 'cpu':
        return quantize_activation_plain(x, channels)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    x = x.contiguous()
    if b > 65535 or h * w * channels >= 2 ** 31:
        raise ValueError(f'{tuple(x.shape)} exceeds the kernel\'s grid')
    out = torch.empty((b, h, w, channels), dtype=torch.int8, device=x.device)
    # word 0: the abs-max's bits, zeroed; word 1: sa
    scratch = torch.zeros(2, dtype=torch.int32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.octseg_quantize_activation(
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4, b, c, channels, h * w, stream)
    if err != 0:
        raise RuntimeError(f'quantize_activation launch failed: CUDA error {err}')
    launches += 1
    return out, scratch.view(torch.float32)[1]
