"""The int8 convolution (K4): the CUDA kernel and its plain version.

Replaces no Pallas kernel: octseg leaves it to XLA,
``lax.conv_general_dilated(xq, wq, ..., preferred_element_type=int32)`` and
the dequantizing epilogue in octseg/ops/quantize.py ``quantized_conv``
(:79-93). ``int8_conv2d(xq, wq, scale, bias, ...)`` takes

- ``xq`` int8 NHWC (B, H, W, Cp), Cp a multiple of 8 (``quantize_activation``
  pads with zero channels);
- ``wq`` int8 (Cout, kh, kw, Cp);
- ``scale`` float32 (Cout,), ``(sa * sw) / (127 * 127)``;
- ``bias`` float32 (Cout,) or None;

and returns NCHW (B, Cout, Ho, Wo) ``float32(acc) * scale (+ bias)`` in
``out_dtype`` (float32 or bfloat16), where ``acc`` is the int32 sum over
(ky, kx, ci) with the given stride, dilation and padding ((top, bottom),
(left, right), zeros).

``int8_conv2d_plain`` computes the sums as a float64 convolution of the
int8 values, exact since |acc| <= 127 * 127 * K < 2**53, rounds them to
int32 and applies the epilogue in torch: what the CPU runs and what the
kernel is held against on the card. The kernel is ``csrc/int8_conv.cu``:
an implicit GEMM with ``mma.sync`` m16n8k32 on s8 tiles staged by cp.async;
see the source's note.

``int8_conv2d`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, on the current stream, without synchronising.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

launches = 0

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def output_size(size: int, kernel: int, stride: int, dilation: int, pad: Tuple[int, int]
                ) -> int:
    """One spatial extent of the convolution's output."""
    return (size + pad[0] + pad[1] - (kernel - 1) * dilation - 1) // stride + 1


def int32_sums_plain(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
                     pads: Pads, dilation: Sequence[int]) -> torch.Tensor:
    """The int32 sums (B, Cout, Ho, Wo), exact, by a float64 convolution."""
    (top, bottom), (left, right) = pads
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (left, right, top, bottom))
    acc = F.conv2d(x, wq.permute(0, 3, 1, 2).double(), None, tuple(stride), 0,
                   tuple(dilation))
    return acc.round().to(torch.int32)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
             out_dtype: torch.dtype) -> torch.Tensor:
    """float32(acc) * scale (+ bias) per output channel, in ``out_dtype``."""
    y = acc.float() * scale.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y.to(out_dtype)


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor], stride: Sequence[int], pads: Pads,
                      dilation: Sequence[int], out_dtype: torch.dtype) -> torch.Tensor:
    return epilogue(int32_sums_plain(xq, wq, stride, pads, dilation), scale, bias, out_dtype)


def _library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load('int8_conv')
    fn = lib.octseg_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    return lib


def _check(xq, wq, scale, bias, out_dtype) -> None:
    if xq.ndim != 4 or wq.ndim != 4:
        raise ValueError(f'xq must be (B, H, W, Cp) and wq (Cout, kh, kw, Cp), got '
                         f'{tuple(xq.shape)} and {tuple(wq.shape)}')
    if xq.shape[3] != wq.shape[3]:
        raise ValueError(f'xq has {xq.shape[3]} channels, wq {wq.shape[3]}: groups other '
                         'than 1 are not supported')
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f'xq and wq must be int8, got {xq.dtype} and {wq.dtype}')
    cout = wq.shape[0]
    for name, t in (('scale', scale), ('bias', bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f'{name} must be float32 ({cout},), got {t.dtype} '
                             f'{tuple(t.shape)}')
    for name, t in (('wq', wq), ('scale', scale), ('bias', bias)):
        if t is not None and t.device != xq.device:
            raise ValueError(f'{name} is on {t.device}, xq on {xq.device}')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'out_dtype must be float32 or bfloat16, got {out_dtype}')


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor], stride: Sequence[int], pads: Pads,
                dilation: Sequence[int], out_dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """NCHW (B, Cout, Ho, Wo) in ``out_dtype``; see the module's note."""
    global launches
    _check(xq, wq, scale, bias, out_dtype)
    if xq.device.type == 'cpu':
        return int8_conv2d_plain(xq, wq, scale, bias, stride, pads, dilation, out_dtype)
    if xq.device.type != 'cuda':
        raise ValueError(f'unsupported device {xq.device}')
    b, h, w, cp = xq.shape
    cout, kh, kw, _ = wq.shape
    if cp % 8:
        raise ValueError(f'the kernel takes a multiple of 8 channels, got {cp}')
    (top, bottom), (left, right) = pads
    sh, sw = (int(s) for s in stride)
    dh, dw = (int(d) for d in dilation)
    ho = output_size(h, kh, sh, dh, (top, bottom))
    wo = output_size(w, kw, sw, dw, (left, right))
    if min(ho, wo) < 1:
        raise ValueError(f'no output pixel for a {h}x{w} input, kernel {kh}x{kw}')
    if b * ho * wo >= 2 ** 31 or kh * kw * cp >= 2 ** 31:
        raise ValueError('the convolution exceeds the kernel\'s 32-bit GEMM extents')
    xq, wq, scale = xq.contiguous(), wq.contiguous(), scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, cout, ho, wo), dtype=out_dtype, device=xq.device)
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.octseg_int8_conv(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), b, h, w, cp, cout, kh, kw, ho, wo, sh, sw,
            dh, dw, top, left, stream)
    if err != 0:
        raise RuntimeError(f'int8_conv2d launch failed: CUDA error {err}')
    launches += 1
    return out
