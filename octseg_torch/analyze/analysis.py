"""Quantification core: area and thickness of one frame's class mask.

The port of ``octseg/analyze/analysis.py``'s numeric functions
(``calculate_thickness_contour``, ``quantify_frame``,
``calculate_object_thickness``), with the same outputs as Python floats on
the same masks. Contours come from ``analyze/contours.py`` (cv2's
``findContours``, ``contourArea`` and ``moments`` without cv2), the tracer
from its host C++ build unless ``native=False``.

The analyze app's ``frame_contours``, ``get_analysis`` and
``_run_inference_into`` are not ported here (ROADMAP.md, "The analyze app,
figures and data-prep entry points").
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from octseg_torch.analyze.contours import contour_areas, contour_moments, find_external_contours

# cv2 5.0's fixed-point BGR -> gray for uint8: 0.114, 0.587 and 0.299 in 15
# bits, rounded half up (equal to cv2 on all 2**24 colours)
_GRAY_SHIFT = 15
_B2Y, _G2Y, _R2Y = 3735, 19235, 9798


def bgr_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` for (H, W, 3) uint8."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected (H, W, 3) uint8, got {img.shape} {img.dtype}')
    c = img.astype(np.int32)
    y = c[..., 0] * _B2Y + c[..., 1] * _G2Y + c[..., 2] * _R2Y + (1 << (_GRAY_SHIFT - 1))
    return (y >> _GRAY_SHIFT).astype(np.uint8)


def calculate_thickness_contour(mask: np.ndarray, native: bool = True) -> Dict[str, Any]:
    """Median/min/max distance from the largest contour to its centroid."""
    empty = {'median': 0, 'min': 0, 'max': 0, 'all_measurements': []}
    contours = find_external_contours(mask, native=native)
    if not contours:
        return empty
    # the first of equal areas, as max(contours, key=cv2.contourArea) picks
    contour = contours[int(np.argmax(contour_areas(contours)))]
    m = contour_moments(contour)
    if m['m00'] == 0:
        return empty
    cx = int(m['m10'] / m['m00'])
    cy = int(m['m01'] / m['m00'])
    pts = contour.reshape(-1, 2).astype(np.float64)
    distances = np.sqrt((pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2)
    return {
        'median': float(np.median(distances)),
        'min': float(np.min(distances)),
        'max': float(np.max(distances)),
        'all_measurements': distances.tolist(),
    }


def quantify_frame(channel: np.ndarray, ratio: int, native: bool = True) -> Dict[str, float]:
    """One frame x one class: area = sqrt(nonzero px // ratio), thickness
    median/min of contour-point distances to the contour centroid, scaled
    by ratio. ``channel`` is a binary (H, W) uint8 mask."""
    thickness = calculate_thickness_contour(channel, native=native)
    return {
        'area': pow(int(np.count_nonzero(channel)) // ratio, 0.5),
        'thickness_mean': thickness['median'] / ratio,
        'thickness_min': thickness['min'] / ratio,
    }


def calculate_object_thickness(mask: np.ndarray) -> Dict[str, Any]:
    """360-degree ray march from the image centre: per degree, the outermost
    radius of the first contiguous run of 255 pixels. A 3-channel uint8
    mask is made gray first, as ``cv2.cvtColor(BGR2GRAY)`` rounds it."""
    if mask.ndim > 2:
        mask = bgr_to_gray_u8(mask)
    height, width = mask.shape
    cx, cy = width // 2, height // 2
    max_radius = int(np.sqrt(width**2 + height**2)) // 2

    angles = np.deg2rad(np.arange(0, 360))[:, None]  # (360, 1)
    rs = np.arange(1, max_radius)[None, :]  # (1, R)
    xs = (cx + rs * np.cos(angles)).astype(np.int32)
    ys = (cy + rs * np.sin(angles)).astype(np.int32)
    inbounds = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    vals = np.where(
        inbounds, mask[np.clip(ys, 0, height - 1), np.clip(xs, 0, width - 1)], 0
    )
    on = vals == 255
    # walk outward, remember the last object pixel, stop at the first
    # off-pixel after having been inside the object (or at the border)
    radii: List[int] = []
    for row_on, row_in in zip(on, inbounds):
        current, found = 0, False
        for r_idx in range(row_on.shape[0]):
            if not row_in[r_idx]:
                break
            if row_on[r_idx]:
                current = r_idx + 1
                found = True
            elif found:
                break
        if found:
            radii.append(current)
    if not radii:
        return {'median': 0, 'min': 0, 'max': 0, 'all_measurements': []}
    return {
        'median': float(np.median(radii)),
        'min': float(np.min(radii)),
        'max': float(np.max(radii)),
        'all_measurements': radii,
    }
