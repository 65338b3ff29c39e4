"""External contours, their area and their moments, as cv2 computes them.

octseg's quantification (``octseg/analyze/analysis.py``) reaches cv2 5.0
for three things, which this module gives without it:

- ``find_external_contours(mask)``: ``cv2.findContours(mask,
  cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]``, the same points, the
  same order of points and the same order of contours (cv2 returns them
  last found first, so of two contours of equal area ``max`` picks the one
  found last in the raster scan);
- ``contour_area(points)``: ``cv2.contourArea``, the unsigned shoelace in
  float64 (``contour_areas`` for a list of contours at once);
- ``contour_moments(points)``: m00, m10 and m01 of ``cv2.moments`` on an
  int32 contour.

The tracer has two implementations: ``csrc/contours.cc``, host C++ built
with g++ at first use and loaded with ctypes, which ``find_external_contours``
uses by default, and ``_find_external_contours_python``, its plain version
(numpy finds each row's value changes, Python follows the borders), which
the tests hold it to. The tracer is inherently sequential, so it stays on
the host. A failed build raises; nothing falls back to the Python version.

Area and moments are equal to cv2's to the bit: on integer points every
product and every partial sum cv2 forms in float64 is an integer below 2**53,
so exact, and here the same sums are taken exactly in int64 before the one
scaling cv2 applies.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np

# chain directions 0..7: right, up-right, up, up-left, left, down-left, down,
# down-right (cv2's order)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_MARK, _MARK_RIGHT = 2, -126
_FLT_EPSILON = 1.1920928955078125e-07


def _trace_python(img: np.ndarray, y0: int, x0: int) -> List[tuple]:
    """Follow the outer border starting at (x0, y0) of the padded int8
    image ``img``, marking it; its CHAIN_APPROX_SIMPLE points, padded
    coordinates."""
    s = s_start = 4
    while True:
        s = (s - 1) & 7
        if img[y0 + _DY[s], x0 + _DX[s]] != 0 or s == s_start:
            break
    if s == s_start:   # a lone pixel
        img[y0, x0] = _MARK_RIGHT
        return [(x0, y0)]
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    y3, x3 = y0, x0
    prev_s = s ^ 4
    pts = []
    while True:
        s_end = s
        while True:   # ends by s_end + 8 at the latest: the pixel it came from
            s += 1
            y4, x4 = y3 + _DY[s & 7], x3 + _DX[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            img[y3, x3] = _MARK_RIGHT
        elif img[y3, x3] == 1:
            img[y3, x3] = _MARK
        if s != prev_s:
            pts.append((x3, y3))
            prev_s = s
        if y4 == y0 and x4 == x0 and y3 == y1 and x3 == x1:
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def _find_external_contours_python(mask: np.ndarray) -> List[np.ndarray]:
    """The plain version of ``csrc/contours.cc`` (its comment states the
    semantics): contours in the order found."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    out = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd, prev, x = 0, 0, 1
        while x <= w:
            changes = np.flatnonzero(row[x:w + 1] != prev)
            if changes.size == 0:
                break
            x += int(changes[0])
            p = int(row[x])
            if prev == 0 and p == 1:
                if row[lnbd] <= 0:   # not inside an enclosing border
                    lnbd = x
                    pts = _trace_python(img, y, x)
                    out.append(np.array(pts, np.int32).reshape(-1, 1, 2) - 1)
                    prev = int(row[x])
                    x += 1
                    continue
            elif p == 0 and prev >= 1 and prev & -2:
                lnbd = x - 1
            prev = p
            if p & -2:
                lnbd = x
            x += 1
    return out


def _contours_library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load_host('contours')
    fn = lib.octseg_find_external_contours
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return lib


def _find_external_contours_native(mask: np.ndarray) -> List[np.ndarray]:
    """``_find_external_contours_python``'s contract, in ``csrc/contours.cc``."""
    fn = _contours_library().octseg_find_external_contours
    h, w = mask.shape
    fg = np.ascontiguousarray(mask != 0).view(np.uint8)
    needed = np.zeros(2, np.int64)
    cap_points, cap_contours = 4 * (h + w) + 64, 64
    while True:
        points = np.empty((cap_points, 2), np.int32)
        ends = np.empty(cap_contours, np.int64)
        n = fn(fg.ctypes.data, h, w, points.ctypes.data, cap_points, ends.ctypes.data,
               cap_contours, needed.ctypes.data)
        if n >= 0:
            break
        cap_points, cap_contours = int(needed[0]), int(needed[1])
    starts = np.concatenate([[0], ends[:n - 1]]) if n else []
    return [points[a:b].reshape(-1, 1, 2).copy() for a, b in zip(starts, ends[:n])]


def find_external_contours(mask: np.ndarray, native: bool = True) -> List[np.ndarray]:
    """``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]`` for a 2-D mask (nonzero is foreground): a
    list of (N, 1, 2) int32 arrays of (x, y) points. ``native=False`` runs
    the plain Python version."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f'expected a 2-D mask, got shape {mask.shape}')
    found = (_find_external_contours_native if native
             else _find_external_contours_python)(mask)
    return found[::-1]


def contour_areas(contours: Sequence[np.ndarray]) -> np.ndarray:
    """``cv2.contourArea`` of each contour, float64, in one numpy pass over
    all their points (a mask of speckle holds thousands of contours)."""
    if not len(contours):
        return np.zeros(0)
    lengths = np.array([len(c) for c in contours])
    p = np.concatenate([np.asarray(c).reshape(-1, 2) for c in contours]).astype(np.int64)
    starts = np.cumsum(lengths) - lengths
    prev = np.arange(len(p)) - 1   # each point's predecessor, the last for the first
    prev[starts] = starts + lengths - 1
    x, y = p[:, 0], p[:, 1]
    a00 = np.add.reduceat(x[prev] * y - y[prev] * x, starts)
    return np.abs(a00 * 0.5)


def contour_area(points: np.ndarray) -> float:
    """``cv2.contourArea(points)``: the unsigned shoelace area of the
    closed polygon, float64."""
    if np.asarray(points).size == 0:
        return 0.0
    return float(contour_areas([points])[0])


def contour_moments(points: np.ndarray) -> Dict[str, float]:
    """m00, m10 and m01 of ``cv2.moments(points)`` for an int32 contour,
    float64 (all 0 for a contour of zero area, as cv2 gives them)."""
    p = np.asarray(points).reshape(-1, 2).astype(np.int64)
    if p.shape[0] == 0:
        return {'m00': 0.0, 'm10': 0.0, 'm01': 0.0}
    x, y = p[:, 0], p[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    dxy = xp * y - x * yp
    a00, a10, a01 = (int(v) for v in (dxy.sum(), (dxy * (xp + x)).sum(), (dxy * (yp + y)).sum()))
    if not abs(a00) > _FLT_EPSILON:
        return {'m00': 0.0, 'm10': 0.0, 'm01': 0.0}
    # cv2's constants, signed as the polygon's orientation
    db1_2, db1_6 = (0.5, 0.16666666666666666666666666666667) if a00 > 0 else (
        -0.5, -0.16666666666666666666666666666667)
    return {'m00': a00 * db1_2, 'm10': a10 * db1_6, 'm01': a01 * db1_6}
