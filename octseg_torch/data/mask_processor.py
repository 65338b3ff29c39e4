"""Binary-mask refinement for the fold builder (the port of
octseg/data/mask_processor.py), without cv2 or scipy.

Every decoded object mask is refined by an elliptical open -> close ->
dilate chain whose kernel is 0.5% of the smaller image side, then only its
three largest contours are kept, redrawn filled:

- the morphology is octseg's composition of ``scipy.ndimage`` binary
  erosions and dilations with cv2's border conventions (erosion pads with
  foreground, dilation with background; dilation runs on the point-reflected
  mask and is reflected back, which matches cv2 for the asymmetric even
  kernels the 0.5% law gives at 512 and 896 px), through data/draw.py's
  numpy ``binary_erosion``/``binary_dilation`` and ``ellipse_kernel``;
- region selection ranks the contours of ``findContours(RETR_TREE,
  CHAIN_APPROX_SIMPLE)`` by ``contourArea`` and keeps every one at or above
  the third-largest area (ties at the cutoff kept), drawn in one even-odd
  fill so holes survive (analyze/contours.py, data/draw.py's
  ``fill_poly``).
"""

from __future__ import annotations

import functools

import numpy as np

from octseg_torch.analyze.contours import contour_areas, find_contours
from octseg_torch.data.draw import binary_dilation, binary_erosion, ellipse_kernel, fill_poly


@functools.lru_cache(maxsize=None)
def _ellipse(size: int) -> np.ndarray:
    se = ellipse_kernel(size).astype(bool)
    se.flags.writeable = False
    return se


def kernel_size_for(shape: tuple) -> int:
    """The kernel law: 0.5% of the smaller dimension, at least 1."""
    return max(int(0.005 * min(shape)), 1)


def _erode(mask: np.ndarray, se: np.ndarray) -> np.ndarray:
    return binary_erosion(mask, se, border_value=1)


def _dilate(mask: np.ndarray, se: np.ndarray) -> np.ndarray:
    return binary_dilation(mask[::-1, ::-1], se, border_value=0)[::-1, ::-1]


def refine_shape(mask: np.ndarray, kernel_size: int | None = None) -> np.ndarray:
    """Open -> close -> dilate with the elliptical kernel; uint8 {0, 1} in
    and out."""
    k = kernel_size if kernel_size is not None else kernel_size_for(mask.shape)
    if k <= 1:
        return mask.astype(np.uint8)  # a 1x1 ellipse: every stage is the identity
    se = _ellipse(k)
    m = mask.astype(bool)
    opened = _dilate(_erode(m, se), se)
    closed = _erode(_dilate(opened, se), se)
    return _dilate(closed, se).astype(np.uint8)


def keep_largest_regions(mask: np.ndarray, keep: int = 3) -> np.ndarray:
    """Everything but the ``keep`` largest contours (by polygon area)
    dropped, the rest redrawn filled in one even-odd pass; every contour tied
    at the cutoff is kept."""
    mask = mask.astype(np.uint8)
    contours = find_contours(mask, 'tree', 'simple')
    out = np.zeros_like(mask)
    if not contours:
        return out
    areas = contour_areas(contours)
    cutoff = np.sort(areas)[-keep] if len(areas) > keep else -np.inf
    return fill_poly(out, [c for c, a in zip(contours, areas) if a >= cutoff], 1)


class MaskProcessor:
    """octseg's names (smooth_mask, remove_artifacts) for the functions
    above."""

    smooth_mask = staticmethod(refine_shape)
    remove_artifacts = staticmethod(keep_largest_regions)
