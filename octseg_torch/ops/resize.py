"""Image resize with OpenCV semantics (the port of octseg/ops/resize.py).

- ``resize_bilinear``: cv2.INTER_LINEAR — half-pixel centers,
  src = (dst + 0.5) * in/out - 0.5, no antialias on downscale; at the edges
  the nearest pixel is repeated. This is ``F.interpolate(mode='bilinear',
  align_corners=False, antialias=False)``. Like the JAX package, it computes
  source coordinates in float32; the two round them differently (XLA fuses
  multiply-adds), which moves a 0..255 result by up to about
  255 * max(in, out) * 2**-23 for some size pairs.
- ``resize_nearest``: cv2.INTER_NEAREST with cv2's index table,
  floor(dst * (1.0 / (out / in))) in float64 — NOT F.interpolate's
  nearest, which is off by one for pairs like 63 -> 35.

Both take NHWC (or HWC) float tensors, the JAX package's layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Float (..., C, H, W) -> (..., C, size[0], size[1])."""
    if tuple(x.shape[-2:]) == tuple(int(s) for s in size):
        return x
    return F.interpolate(x, size=tuple(int(s) for s in size), mode='bilinear',
                         align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize NHWC (or HWC) to (H, W) = size with cv2.INTER_LINEAR semantics."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = resize_bilinear_nchw(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """cv2 resizeNN source index per output index, bit-exact: the scale is
    the double-rounded reciprocal 1.0 / (out / in), in float64."""
    scale = 1.0 / (out_size / in_size)
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest_nchw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    rows = torch.from_numpy(nearest_indices(int(size[0]), x.shape[-2])).to(x.device)
    cols = torch.from_numpy(nearest_indices(int(size[1]), x.shape[-1])).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize NHWC (or HWC) to size with cv2.INTER_NEAREST semantics."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = resize_nearest_nchw(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    return out[0] if squeeze else out
