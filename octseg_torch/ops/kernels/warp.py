"""Augmentation warp: the CUDA kernel and its plain version.

Replaces TPU kernel K2, octseg/ops/pallas/resample.py (``_pass_call``,
entry ``warp_pair_2pass``). ``warp_pair(imgs, masks, mats)`` warps
(N, H, W, Ci) float32 images bilinearly and (N, H, W, Cm) float32 masks by
nearest tap through (N, 3, 3) float32 inverse homographies, zero border,
taps rounded to bfloat16: the semantics of octseg's ``_sample_pair_fused``,
at any frame shape, square or not.

``ops/warp.sample_pair_plain`` computes this in plain torch; it is what the
CPU runs and what the kernel is held against on the card. The kernel is
``csrc/warp.cu``: memory-bound (56 B per pixel at 3 + 4 channels), 32-bit
indices inside a sample, 16 B mask loads and stores and image stores
staged through shared memory at 3 + 4 channels, a general path for other
counts; see the source's note.

``warp_pair`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, on the current stream, without synchronising.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from octseg_torch.ops.warp import sample_pair_plain

launches = 0


def _library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load('warp')
    fn = lib.octseg_warp_pair
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _check(imgs: torch.Tensor, masks: torch.Tensor, mats: torch.Tensor) -> None:
    if imgs.ndim != 4 or masks.ndim != 4:
        raise ValueError(f'imgs and masks must be (N, H, W, C), got {tuple(imgs.shape)} '
                         f'and {tuple(masks.shape)}')
    if imgs.shape[:3] != masks.shape[:3]:
        raise ValueError(f'imgs {tuple(imgs.shape)} and masks {tuple(masks.shape)} '
                         'differ in (N, H, W)')
    if tuple(mats.shape) != (imgs.shape[0], 3, 3):
        raise ValueError(f'mats must be ({imgs.shape[0]}, 3, 3), got {tuple(mats.shape)}')
    for name, t in (('imgs', imgs), ('masks', masks), ('mats', mats)):
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if t.device != imgs.device:
            raise ValueError(f'{name} is on {t.device}, imgs on {imgs.device}')


def warp_pair(imgs: torch.Tensor, masks: torch.Tensor, mats: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(warped images, warped masks), float32, the shapes of the inputs."""
    global launches
    _check(imgs, masks, mats)
    if imgs.device.type == 'cpu':
        return sample_pair_plain(imgs, masks, mats)
    if imgs.device.type != 'cuda':
        raise ValueError(f'unsupported device {imgs.device}')
    if not (imgs.is_contiguous() and masks.is_contiguous() and mats.is_contiguous()):
        raise ValueError('imgs, masks and mats must be contiguous')
    n, h, w, ci = imgs.shape
    cm = masks.shape[3]
    if h * w * max(ci, cm) >= 2 ** 31:
        raise ValueError(f'a sample of {h}x{w}x{max(ci, cm)} values does not fit the '
                         "kernel's 32-bit indices")
    img_out = torch.empty_like(imgs)
    mask_out = torch.empty_like(masks)
    if n * h * w == 0:
        return img_out, mask_out
    lib = _library()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.octseg_warp_pair(imgs.data_ptr(), masks.data_ptr(), mats.data_ptr(),
                                   img_out.data_ptr(), mask_out.data_ptr(),
                                   n, h, w, ci, cm, stream)
    if err != 0:
        raise RuntimeError(f'warp_pair launch failed: CUDA error {err}')
    launches += 1
    return img_out, mask_out
