"""cv2's polygon fill, filled ellipse, elliptical kernel, histogram
equalisation and polygon approximation, and scipy's binary morphology,
without cv2 or scipy, bit-exact with cv2 5.0 and scipy.

octseg's data prep and analyze app call these library functions; the card's
machine has no cv2, and the port may not import scipy:

- ``fill_poly(img, polygons, value)``: ``cv2.fillPoly(img, polygons, value)``
  and ``cv2.drawContours(img, polygons, -1, value, thickness=cv2.FILLED)``,
  which run the same code: each polygon's edges are drawn as 8-connected
  Bresenham lines (``Line``, clipped to the image) and collected, then one
  even-odd scanline fill runs over the edges of all polygons at once
  (``FillEdgeCollection``, 16-bit fixed-point x), so holes survive. As cv2
  5.0 does (found against it, not in a textbook): a span's left end rounds
  up and its right end down, with no half-pixel offset, and an edge that
  leaves the image runs through its clipped end points, or, where the clip
  leaves a horizontal segment, vertically at the clipped x over the edge's
  rows;
- ``fill_ellipse(img, center, axes, value)``: ``cv2.ellipse(img, center,
  axes, 0, 0, 360, value, -1)``: ``ellipse2Poly`` over cv2's 7-decimal sine
  table in 16-bit fixed point, then ``FillConvexPoly`` (outline by the
  fixed-point ``Line2``, then its two-edge scan);
- ``ellipse_kernel(k)``: ``cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
  (k, k))``;
- ``binary_erosion`` and ``binary_dilation``: ``scipy.ndimage``'s of a 2-D
  bool mask by a structuring element with the default origin, out-of-image
  pixels read as ``border_value``;
- ``approx_poly_dp(points, epsilon, closed)``: ``cv2.approxPolyDP`` of an
  int32 contour (Douglas-Peucker from two far points of a closed curve,
  with each point's distance to the segment, not the line; then cv2's pass
  that drops points on almost straight lines); the plain version of
  ``csrc/contours.cc``'s, which the analyze app runs;
- ``equalize_hist(gray)``: ``cv2.equalizeHist`` of a uint8 image;
- ``rgb_to_gray(img)``: ``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``.

All of this is host work run once per dataset build or per analysed frame.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# cv2's fixed-point RGB -> gray for uint8 (15 bits, rounded half up), the
# coefficients of analyze/analysis.py's bgr_to_gray_u8 in RGB order
_GRAY_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735
# cv2's SinTable (drawing.cpp): sin of 0..450 degrees as 7-decimal float
# literals
_SIN_TABLE = np.array([round(math.sin(math.radians(a)), 7) for a in range(451)],
                      np.float32).astype(np.float64)


def _idiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round_half_even(v: float) -> int:
    """cvRound of a double (the SSE conversion rounds half to even)."""
    return int(np.rint(v))


# --------------------------------- lines -----------------------------------

def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int
              ) -> Tuple[bool, int, int, int, int]:
    """cv2.clipLine on an image of ``width`` x ``height``: (inside, the
    clipped end points). The end points are moved only when the line may
    cross the image, as cv2 moves them."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """cv2's ``Line`` with 8-connectivity: a LineIterator from left to right
    over the clipped segment, Bresenham with err = dx - 2 dy."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    n = major + 1
    steps = np.empty(n, np.int64)   # the minor axis' position at each pixel
    pos = 0
    for i in range(n):
        steps[i] = pos
        if err < 0:
            pos += 1
            err += 2 * major - 2 * minor
        else:
            err -= 2 * minor
    along = np.arange(n)
    if vert:
        img[y1 + sy * along, x1 + steps] = value
    else:
        img[y1 + sy * steps, x1 + along] = value


def _line2(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], value) -> None:
    """cv2's ``Line2``: a line between 16-bit fixed-point end points, clipped
    in fixed point, one pixel per step of the major axis plus the rounded
    end point."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _idiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _idiv(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    xs = [(x2 + (XY_ONE >> 1)) >> XY_SHIFT]
    ys = [(y2 + (XY_ONE >> 1)) >> XY_SHIFT]
    k = np.arange(ecount + 1, dtype=np.int64) if ecount >= 0 else np.zeros(0, np.int64)
    if ax > ay:
        xs = np.concatenate([xs, (x1 >> XY_SHIFT) + k])
        ys = np.concatenate([ys, (y1 + k * y_step) >> XY_SHIFT])
    else:
        xs = np.concatenate([xs, (x1 + k * x_step) >> XY_SHIFT])
        ys = np.concatenate([ys, (y1 >> XY_SHIFT) + k])
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = value


# ------------------------------ polygon fill -------------------------------

def _collect_poly_edges(img: np.ndarray, pts: np.ndarray, value, edges: list) -> None:
    """cv2's ``CollectPolyEdges`` for integer points (shift 0, LINE_8):
    draws each edge and appends [y0, y1, x, dx] for every non-horizontal
    one."""
    h, w = img.shape[:2]
    n = len(pts)
    x0, y0 = int(pts[n - 1][0]) << XY_SHIFT, int(pts[n - 1][1])
    for k in range(n):
        x1, y1 = int(pts[k][0]) << XY_SHIFT, int(pts[k][1])
        t0x, t1x = (x0 + (XY_ONE >> 1)) >> XY_SHIFT, (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        _line8(img, t0x, y0, t1x, y1, value)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= y0 < h and 0 <= y1 < h):
            # the edge runs through the clipped end points; where the clip
            # leaves a horizontal segment, at their x over the original rows
            _ok, t0x, t0y, t1x, t1y = clip_line(w, h, t0x, y0, t1x, y1)
            c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        if y0 != y1:
            dx = _idiv(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx])
            else:
                edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx])
        x0, y0 = x1, y1


def _fill_edge_collection(img: np.ndarray, edges: list, value) -> None:
    """cv2's ``FillEdgeCollection`` (LINE_8): an active edge list walked in
    x order per scanline, spans between the 1st and 2nd, 3rd and 4th ...
    edge filled, an edge's x advanced only when its span is drawn."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    x_ends = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(x_ends) < 0 or min(x_ends) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active: List[list] = []
    i = 0
    for y in range(edges[0][0], y_max):
        # merge the active list with the edges that start on this row, in
        # cv2's order: an edge starting here goes before the first active
        # edge whose x is not below its own
        merged: List[list] = []
        a = 0
        while a < len(active) or (i < total and edges[i][0] == y):
            if a < len(active) and active[a][1] == y:
                a += 1   # the edge ends on this row
                continue
            if a < len(active) and (i >= total or edges[i][0] > y or active[a][2] < edges[i][2]):
                merged.append(active[a])
                a += 1
            elif i < total and edges[i][0] == y:
                merged.append(edges[i])
                i += 1
            else:
                break
        for k in range(1, len(merged), 2):
            left, right = merged[k - 1], merged[k]
            if y >= 0:
                # the span's left end rounds up, its right end down
                if left[2] > right[2]:
                    x1, x2 = (right[2] + XY_ONE - 1) >> XY_SHIFT, left[2] >> XY_SHIFT
                else:
                    x1, x2 = (left[2] + XY_ONE - 1) >> XY_SHIFT, right[2] >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            left[2] += left[3]
            right[2] += right[3]
        merged.sort(key=lambda e: e[2])   # cv2's bubble sort is stable
        active = merged


def fill_poly(img: np.ndarray, polygons: Sequence[np.ndarray], value) -> np.ndarray:
    """``cv2.fillPoly(img, polygons, value)`` (and ``cv2.drawContours(img,
    polygons, -1, value, cv2.FILLED)``) in place on a 2-D uint8 image;
    each polygon is an (N, 2) or (N, 1, 2) array of integer (x, y) points.
    Returns ``img``."""
    edges: list = []
    for poly in polygons:
        pts = np.asarray(poly).reshape(-1, 2)
        if len(pts):
            _collect_poly_edges(img, pts, value, edges)
    _fill_edge_collection(img, edges, value)
    return img



# --------------------------------- ellipse ---------------------------------

def _ellipse_points(center: Tuple[int, int], axes: Tuple[int, int]) -> List[Tuple[int, int]]:
    """``EllipseEx``'s polygon of a whole unrotated ellipse, 16-bit fixed
    point: ``ellipse2Poly`` every ``delta`` degrees, rounded, repeats
    dropped."""
    cx, cy = center[0] << XY_SHIFT, center[1] << XY_SHIFT
    aw, ah = abs(axes[0]) << XY_SHIFT, abs(axes[1]) << XY_SHIFT
    delta = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    out: List[Tuple[int, int]] = []
    for angle in range(0, 360 + delta, delta):
        angle = min(angle, 360)
        # alpha = cos 0 = 1 and beta = sin 0 = 0 exactly
        vx = float(cx) + float(aw) * _SIN_TABLE[450 - angle]
        vy = float(cy) + float(ah) * _SIN_TABLE[angle]
        px = _round_half_even(vx / XY_ONE) << XY_SHIFT
        py = _round_half_even(vy / XY_ONE) << XY_SHIFT
        px += _round_half_even(vx - px)
        py += _round_half_even(vy - py)
        if not out or out[-1] != (px, py):
            out.append((px, py))
    if len(out) == 1:
        out = [(cx, cy), (cx, cy)]
    return out


def _fill_convex_poly(img: np.ndarray, v: List[Tuple[int, int]], value) -> None:
    """cv2's ``FillConvexPoly`` for 16-bit fixed-point points (shift
    XY_SHIFT, LINE_8): every edge drawn by ``Line2``, then two edge chains
    walked down from the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for k, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], k
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(img, p0, p, value)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # [idx, di, x, dx, ye] per chain
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges_left = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges_left > 0:
                    edges_left -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _idiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges_left -= 1
        if edges_left < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            xx1 = (left[2] + delta) >> XY_SHIFT
            xx2 = (right[2] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center: Tuple[int, int], axes: Tuple[int, int],
                 value) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, value, -1)`` in place on
    a 2-D uint8 image (integer centre and semi-axes). Returns ``img``."""
    _fill_convex_poly(img, _ellipse_points((int(center[0]), int(center[1])),
                                           (int(axes[0]), int(axes[1]))), value)
    return img


# ------------------------------- morphology --------------------------------

def ellipse_kernel(k: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))`` as uint8."""
    if k == 1:
        return np.ones((1, 1), np.uint8)
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = _round_half_even(c * math.sqrt((r * r - dy * dy) * inv_r2))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def _shifted(mask: np.ndarray, dy: int, dx: int, border: bool) -> np.ndarray:
    """out[i, j] = mask[i + dy, j + dx], ``border`` outside the image."""
    h, w = mask.shape
    out = np.full((h, w), border, bool)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = mask[ys, xs]
    return out


def binary_erosion(mask: np.ndarray, structure: np.ndarray, border_value: int = 0
                   ) -> np.ndarray:
    """``scipy.ndimage.binary_erosion(mask, structure,
    border_value=border_value)`` for 2-D input: out[i] = AND over the
    structure's set offsets j of mask[i + j - k // 2]."""
    m = np.asarray(mask).astype(bool)
    se = np.asarray(structure).astype(bool)
    cy, cx = se.shape[0] // 2, se.shape[1] // 2
    out = np.ones(m.shape, bool)
    for a, b in zip(*np.nonzero(se)):
        out &= _shifted(m, int(a) - cy, int(b) - cx, bool(border_value))
    return out


def binary_dilation(mask: np.ndarray, structure: np.ndarray, border_value: int = 0
                    ) -> np.ndarray:
    """``scipy.ndimage.binary_dilation(mask, structure,
    border_value=border_value)`` for 2-D input: the erosion's complement
    with the point-reflected structure (origin moved by one along an even
    axis, as scipy moves it)."""
    m = np.asarray(mask).astype(bool)
    se = np.asarray(structure).astype(bool)
    ky, kx = se.shape
    # scipy reflects the structure and, along an even axis, moves the
    # origin to -1: offsets are then j - (k // 2 - 1) of the reflected one
    cy, cx = ky // 2 - (1 - ky % 2), kx // 2 - (1 - kx % 2)
    ref = se[::-1, ::-1]
    out = np.zeros(m.shape, bool)
    for a, b in zip(*np.nonzero(ref)):
        out |= _shifted(m, int(a) - cy, int(b) - cx, bool(border_value))
    return out


# --------------------------- polygon approximation -------------------------

def _segment_dist2(pt, start, end, dx: float, dy: float, len2: float) -> float:
    """Squared distance of ``pt`` to the segment from ``start`` to
    ``end`` (its nearer end point where it projects outside)."""
    px, py = float(pt[0] - start[0]), float(pt[1] - start[1])
    dot = px * dx + py * dy
    if dot <= 0:
        return px * px + py * py
    if dot >= len2:
        ex, ey = float(pt[0] - end[0]), float(pt[1] - end[1])
        return ex * ex + ey * ey
    cross = py * dx - px * dy
    return cross * cross / len2


def approx_poly_dp(points: np.ndarray, epsilon: float, closed: bool) -> np.ndarray:
    """``cv2.approxPolyDP(points, epsilon, closed)`` for an integer contour
    (N, 1, 2) or (N, 2): (M, 1, 2) int32."""
    src = [tuple(int(v) for v in p) for p in np.asarray(points).reshape(-1, 2)]
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps = float(epsilon) ** 2
    dst: List[Tuple[int, int]] = [(0, 0)] * count
    new_count = 0
    stack: List[Tuple[int, int]] = []
    is_closed = closed
    init_iters = 3
    slice_start = slice_end = 0
    right_start = right_end = 0
    start_pt = (-1000000, -1000000)
    pos = 0

    def write(pt):
        nonlocal new_count
        dst[new_count] = pt
        new_count += 1

    if not is_closed:
        right_start = count
        end_pt, start_pt = src[0], src[count - 1]
        if start_pt != end_pt:
            slice_start, slice_end = 0, count - 1
            stack.append((slice_start, slice_end))
        else:
            is_closed = True
            init_iters = 1
    if is_closed:
        right_start = 0
        le_eps = False
        for _ in range(init_iters):
            max_dist = 0.0
            pos = (pos + right_start) % count
            start_pt = src[pos]
            pos = pos + 1 if pos + 1 < count else 0
            for j in range(1, count):
                pt = src[pos]
                pos = pos + 1 if pos + 1 < count else 0
                dx, dy = float(pt[0] - start_pt[0]), float(pt[1] - start_pt[1])
                dist = dx * dx + dy * dy
                if dist > max_dist:
                    max_dist = dist
                    right_start = j
            le_eps = max_dist <= eps
        if not le_eps:
            right_end = slice_start = pos % count
            slice_end = right_start = (right_start + slice_start) % count
            stack.append((right_start, right_end))
            stack.append((slice_start, slice_end))
        else:
            write(start_pt)
    while stack:
        slice_start, slice_end = stack.pop()
        end_pt = src[slice_end]
        pos = slice_start
        start_pt = src[pos]
        pos = pos + 1 if pos + 1 < count else 0
        if pos != slice_end:
            max_dist = 0.0
            dx, dy = float(end_pt[0] - start_pt[0]), float(end_pt[1] - start_pt[1])
            len2 = dx * dx + dy * dy
            while pos != slice_end:
                pt = src[pos]
                pos = pos + 1 if pos + 1 < count else 0
                dist = _segment_dist2(pt, start_pt, end_pt, dx, dy, len2)
                if dist > max_dist:
                    max_dist = dist
                    right_start = (pos + count - 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
            start_pt = src[slice_start]
        if le_eps:
            write(start_pt)
        else:
            right_end = slice_end
            slice_end = right_start
            stack.append((right_start, right_end))
            stack.append((slice_start, slice_end))
    if not is_closed:
        write(src[count - 1])

    # drop extra points on [almost] straight lines
    is_closed = closed
    count = new_count
    pos = count - 1 if is_closed else 0

    def read(p):
        return dst[p], (p + 1 if p + 1 < count else 0)

    start_pt, pos = read(pos)
    wpos = pos
    pt, pos = read(pos)
    i = 0 if is_closed else 1
    while i < count - (0 if is_closed else 1) and new_count > 2:
        end_pt, pos = read(pos)
        dx, dy = float(end_pt[0] - start_pt[0]), float(end_pt[1] - start_pt[1])
        dist = abs((pt[0] - start_pt[0]) * dy - (pt[1] - start_pt[1]) * dx)
        inner = ((pt[0] - start_pt[0]) * (end_pt[0] - pt[0])
                 + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1]))
        if dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0 and dy != 0 \
                and inner >= 0:
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = wpos + 1 if wpos + 1 < count else 0
            pt, pos = read(pos)
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = wpos + 1 if wpos + 1 < count else 0
        pt = end_pt
        i += 1
    if not is_closed:
        dst[wpos] = pt
    return np.array(dst[:new_count], np.int32).reshape(-1, 1, 2)


# --------------------------------- colour ----------------------------------

def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for (H, W, 3) uint8."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected (H, W, 3) uint8, got {img.shape} {img.dtype}')
    c = img.astype(np.int32)
    y = c[..., 0] * _R2Y + c[..., 1] * _G2Y + c[..., 2] * _B2Y + (1 << (_GRAY_SHIFT - 1))
    return (y >> _GRAY_SHIFT).astype(np.uint8)


def equalize_hist(gray: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 image: the cumulative histogram past
    the first occupied bin, times (255 / (pixels - that bin's count)) in
    float32, rounded half to even."""
    if gray.dtype != np.uint8:
        raise ValueError(f'equalize_hist takes uint8, got {gray.dtype}')
    hist = np.bincount(gray.reshape(-1), minlength=256)
    first = int(np.flatnonzero(hist)[0]) if gray.size else 0
    total = gray.size
    if total == 0 or hist[first] == total:
        return np.full_like(gray, first)
    scale = np.float32(255.0) / np.float32(total - hist[first])
    lut = np.zeros(256, np.uint8)
    sums = np.cumsum(hist[first + 1:]).astype(np.float32)
    lut[first + 1:] = np.clip(np.rint(sums * scale), 0, 255).astype(np.uint8)
    return lut[gray]
