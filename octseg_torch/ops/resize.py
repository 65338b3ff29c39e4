"""Image resize (the port of octseg/ops/resize.py).

- ``resize_bilinear``: what octseg computes, ``jax.image.resize(x, ...,
  'linear', antialias=False)``: half-pixel centres, no antialias on a
  downscale, the edge pixel's weight renormalised to 1 at the borders. Like
  jax, it contracts each resized axis with a float32 weight matrix built as
  ``jax._src.image.scale.compute_weight_mat`` builds it: sample positions
  (arange(out) + 0.5) * float32(1 / scale) - 0.5, triangle weights, columns
  normalised by their sum, zero outside [-0.5, in - 0.5], with the
  position rounded as XLA rounds it on the CPU (see
  ``FUSED_POSITIONS_FROM``). An axis whose size does not change is not
  touched. Callers on the card run it under
  ``infer.engine.fp32_exact`` (no TF32).
- ``resize_nearest``: cv2.INTER_NEAREST with cv2's index table,
  floor(dst * (1.0 / (out / in))) in float64 — NOT F.interpolate's
  nearest, which is off by one for pairs like 63 -> 35.

Both take NHWC (or HWC) float tensors, the JAX package's layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from octseg_torch.data.image import nearest_indices  # cv2's resizeNN index, numpy


# XLA on the CPU evaluates the sample position (i + 0.5) * inv - 0.5 with one
# rounding (a fused multiply-add) on an axis of this many outputs or more,
# and with two below (measured against jax 0.9, jit, x86-64): the port
# rounds as it does, which keeps it within 1e-4 of octseg's result on a
# 0..255 scale (4.6e-5 the largest gap over 35 size pairs, both ways).
# Either rounding alone misses 1e-4 on 3 or 4 of the 11 size pairs of
# tests/test_torch_ops.py (test_resize_bilinear_needs_both_position_roundings
# names them); the threshold is fitted to that compiler, and the
# float64 test there is the guard that does not depend on it.
FUSED_POSITIONS_FROM = 96


def linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax.image.resize's 'linear'
    kernel without antialias (``compute_weight_mat``)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    centre = np.arange(out_size, dtype=f32) + f32(0.5)
    if out_size >= FUSED_POSITIONS_FROM:
        # exact product and difference in float64, one rounding to float32
        sample = (centre.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    else:
        sample = centre * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    weights = np.maximum(f32(0), f32(1) - dist)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_bilinear_nchw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Float (..., H, W) -> (..., size[0], size[1])."""
    out_h, out_w = int(size[0]), int(size[1])
    if x.shape[-1] != out_w:
        wt = torch.from_numpy(linear_weights(x.shape[-1], out_w))
        x = torch.matmul(x, wt.to(x.device, x.dtype))
    if x.shape[-2] != out_h:
        wt = torch.from_numpy(np.ascontiguousarray(linear_weights(x.shape[-2], out_h).T))
        x = torch.matmul(wt.to(x.device, x.dtype), x)
    return x


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize NHWC (or HWC) to (H, W) = size as octseg's resize_bilinear."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = resize_bilinear_nchw(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


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
