"""Fused overlay postprocess: the CUDA kernel and its plain version.

Replaces the TPU kernel octseg/ops/pallas/postprocess.py
(``_fused_overlay_postprocess``, public ``fused_overlay_postprocess``). For a
stack of binary masks (M, H, W) float32 it returns ``(fill, ring)``:

    closed = close(m, ELLIPSE_5)
    ring   = dilate(closed, ELLIPSE_7) * (1 - erode(closed, ELLIPSE_7))
    fill   = gaussian_blur5(closed)

``postprocess_chain`` computes this in plain torch (ops/morphology.py); it is
what the CPU runs and what the kernel is held against on the card. The
kernel is ``csrc/postprocess.cu``: memory-bound (4 B read + 8 B written per
pixel); it packs the masks into 32-pixel words in shared memory, dilates by
shift-and-OR and blurs in integers; see the source's note.

``fused_overlay_postprocess`` takes the plain chain for a CPU tensor and
launches the kernel for a CUDA tensor, on the current stream, without
synchronising. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from octseg_torch.ops.morphology import ELLIPSE_5, ELLIPSE_7, close, dilate, erode, gaussian_blur5

launches = 0


def postprocess_chain(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch (fill, ring) for (..., H, W) binary float masks."""
    closed = close(masks, ELLIPSE_5)
    ring = dilate(closed, ELLIPSE_7) * (1.0 - (erode(closed, ELLIPSE_7) > 0).float())
    fill = gaussian_blur5(closed)
    return fill, ring


def _library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load('postprocess')
    fn = lib.octseg_fused_overlay_postprocess
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def fused_overlay_postprocess(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fill, ring), each (M, H, W) float32, for masks (M, H, W) float32 {0,1}."""
    global launches
    if masks.ndim != 3:
        raise ValueError(f'masks must be (M, H, W), got shape {tuple(masks.shape)}')
    if masks.shape[1] < 3 or masks.shape[2] < 3:
        raise ValueError('REFLECT_101 blur needs H and W >= 3, got '
                         f'{tuple(masks.shape[1:])}')
    if masks.dtype != torch.float32:
        raise TypeError(f'masks must be float32, got {masks.dtype}')
    if masks.device.type == 'cpu':
        return postprocess_chain(masks)
    if masks.device.type != 'cuda':
        raise ValueError(f'unsupported device {masks.device}')
    if not masks.is_contiguous():
        raise ValueError('masks must be contiguous')
    m, h, w = masks.shape
    fill = torch.empty_like(masks)
    ring = torch.empty_like(masks)
    if m == 0:
        return fill, ring
    lib = _library()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = lib.octseg_fused_overlay_postprocess(
            masks.data_ptr(), fill.data_ptr(), ring.data_ptr(), m, h, w, stream)
    if err != 0:
        raise RuntimeError(f'fused_overlay_postprocess launch failed: CUDA error {err}')
    launches += 1
    return fill, ring
