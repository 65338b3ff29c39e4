"""octseg_torch's drawing, morphology and contour functions against cv2 5.0
and scipy, bit for bit.

Each input is made from a seed with numpy. ``fill_poly`` must equal
``cv2.fillPoly`` and ``cv2.drawContours(..., cv2.FILLED)`` (degenerate,
collinear, self-crossing polygons, several at once, points off the image,
contours with nested holes); ``fill_ellipse`` ``cv2.ellipse(img, c, r, 0, 0,
360, 255, -1)`` at the radii the crop law makes and at random ones with 0
and 1; ``ellipse_kernel`` ``cv2.getStructuringElement(MORPH_ELLIPSE)``;
``binary_erosion``/``binary_dilation`` scipy.ndimage's; ``find_contours``
``cv2.findContours`` in RETR_TREE/CHAIN_APPROX_SIMPLE and
RETR_EXTERNAL/CHAIN_APPROX_NONE, in C++ and in Python, points and order
(ties of equal area included); ``approx_poly_dp`` ``cv2.approxPolyDP``;
``equalize_hist`` and ``rgb_to_gray`` cv2's. Tolerance: none anywhere.
"""

import math

import cv2
import numpy as np
import pytest
from scipy import ndimage

from octseg_torch.analyze import contours as C
from octseg_torch.data import draw as D
from tests.torch_threads import torch_threads_share  # noqa: F401


def _fill_both(h, w, polys):
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, [np.asarray(p, np.int32) for p in polys], 1)
    got = D.fill_poly(np.zeros((h, w), np.uint8), polys, 1)
    return got, want


@pytest.mark.parametrize('kind', ['inside', 'one past the edges', 'off the image',
                                  'several', 'star'])
def test_fill_poly_equals_cv2(kind):
    rng = np.random.default_rng(['inside', 'one past the edges', 'off the image', 'several',
                                 'star'].index(kind))
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(2, 40, 2))
        n = int(rng.integers(1, 9))
        if kind == 'inside':
            polys = [np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)]
        elif kind == 'one past the edges':   # polygon_to_mask's local masks
            polys = [np.stack([rng.integers(0, w + 1, n), rng.integers(0, h + 1, n)], 1)]
        elif kind == 'off the image':
            polys = [rng.integers(-15, 55, (n, 2))]
        elif kind == 'several':
            polys = [rng.integers(-3, 43, (int(rng.integers(2, 7)), 2)) for _ in range(3)]
        else:   # self-crossing stars
            k = int(rng.integers(2, 4))
            t = np.arange(5) * 2 * np.pi * k / 5
            polys = [np.stack([w / 2 + w / 2.2 * np.cos(t), h / 2 + h / 2.2 * np.sin(t)],
                              1).astype(int)]
        got, want = _fill_both(h, w, polys)
        np.testing.assert_array_equal(got, want, err_msg=str([p.tolist() for p in polys]))


def test_fill_poly_degenerate_polygons():
    cases = [[[3, 3]], [[1, 1], [8, 1]], [[2, 2], [2, 9]], [[1, 1], [5, 5], [9, 9]],
             [[0, 0], [9, 9], [0, 9], [9, 0]], [[4, 4], [4, 4], [4, 4]],
             [[-5, 3], [20, 3]], [[0, 3], [-1, -2]], [[2, 3], [-1, -2], [4, -3]]]
    for poly in cases:
        got, want = _fill_both(10, 10, [np.array(poly)])
        np.testing.assert_array_equal(got, want, err_msg=str(poly))


def _blobs(rng, h, w, holes=True):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(2, 6))):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(4, 14)
        d = (yy - cy) ** 2 + (xx - cx) ** 2
        m |= d < r * r
        if holes:
            m &= ~((d < (r // 2) ** 2) & (d >= (r // 4) ** 2))
    return m.astype(np.uint8)


def test_draw_contours_filled_keeps_holes():
    rng = np.random.default_rng(5)
    for _ in range(40):
        m = _blobs(rng, 48, 56)
        contours = cv2.findContours(m, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)[0]
        for pick in (contours, contours[::2]):
            want = cv2.drawContours(np.zeros_like(m), list(pick), -1, 1, thickness=cv2.FILLED)
            got = D.fill_poly(np.zeros_like(m), pick, 1)
            np.testing.assert_array_equal(got, want)


def test_sine_table_equals_cv2():
    # ellipse2Poly at a radius of 1e7 reads every entry to its 7 decimals
    pts = cv2.ellipse2Poly((0, 0), (10 ** 7, 10 ** 7), 0, 0, 360, 1)
    xs = [int(np.rint(1e7 * D._SIN_TABLE[450 - a])) for a in range(360)]
    ys = [int(np.rint(1e7 * D._SIN_TABLE[a])) for a in range(360)]
    np.testing.assert_array_equal(pts[:360, 0], xs)
    np.testing.assert_array_equal(pts[:360, 1], ys)


@pytest.mark.parametrize('side', [120, 512, 704, 896, 1000])
def test_fill_ellipse_at_the_crop_law(side):
    # configs/convert_int_to_cv.yaml's crop scaled to the frame
    crop = [[side // 8, 0], [side - side // 8, side * 3 // 4]]
    (x1, y1), (x2, y2) = crop
    center, radii = ((x1 + x2) // 2, (y1 + y2) // 2), ((x2 - x1) // 2, (y2 - y1) // 2)
    want = cv2.ellipse(np.zeros((side, side), np.uint8), center, radii, 0, 0, 360, 255, -1)
    np.testing.assert_array_equal(D.fill_ellipse(np.zeros((side, side), np.uint8), center,
                                                 radii, 255), want)


def test_fill_ellipse_random_radii():
    rng = np.random.default_rng(7)
    radii = [(0, 0), (1, 1), (0, 5), (1, 0), (2, 1), (9, 14), (15, 3)]
    radii += [tuple(int(v) for v in rng.integers(0, 45, 2)) for _ in range(150)]
    for rx, ry in radii:
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        c = (int(rng.integers(-10, w + 10)), int(rng.integers(-10, h + 10)))
        want = cv2.ellipse(np.zeros((h, w), np.uint8), c, (rx, ry), 0, 0, 360, 255, -1)
        got = D.fill_ellipse(np.zeros((h, w), np.uint8), c, (rx, ry), 255)
        np.testing.assert_array_equal(got, want, err_msg=f'{c} {(rx, ry)}')


@pytest.mark.parametrize('k', range(1, 12))
def test_ellipse_kernel_equals_cv2(k):
    np.testing.assert_array_equal(
        D.ellipse_kernel(k), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))


@pytest.mark.parametrize('k', range(1, 8))
def test_binary_morphology_equals_scipy(k):
    rng = np.random.default_rng(k)
    se = D.ellipse_kernel(k).astype(bool)
    for _ in range(8):
        m = rng.random((33, 41)) > rng.uniform(0.2, 0.8)
        for border in (0, 1):
            np.testing.assert_array_equal(D.binary_erosion(m, se, border),
                                          ndimage.binary_erosion(m, se, border_value=border))
            np.testing.assert_array_equal(D.binary_dilation(m, se, border),
                                          ndimage.binary_dilation(m, se, border_value=border))
        # octseg's reflected dilation, and cv2's own erosion and dilation
        np.testing.assert_array_equal(
            D.binary_dilation(m[::-1, ::-1], se, 0)[::-1, ::-1],
            cv2.dilate(m.astype(np.uint8), se.astype(np.uint8)).astype(bool))
        np.testing.assert_array_equal(
            D.binary_erosion(m, se, 1), cv2.erode(m.astype(np.uint8), se.astype(np.uint8)) > 0)


_MODES = {('tree', 'simple'): (cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE),
          ('external', 'none'): (cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE),
          ('external', 'simple'): (cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)}


def _masks(seed):
    rng = np.random.default_rng(seed)
    out = [_blobs(rng, 50, 64) for _ in range(6)]
    out += [(rng.random((int(h), int(w))) > rng.uniform(0.3, 0.7)).astype(np.uint8)
            for h, w in rng.integers(1, 30, (8, 2))]
    m = np.zeros((40, 40), np.uint8)   # nested: ring, hole, ring, hole, blob
    yy, xx = np.mgrid[:40, :40]
    d = (yy - 20) ** 2 + (xx - 20) ** 2
    for r, v in ((18, 1), (14, 0), (10, 1), (6, 0), (3, 1)):
        m[d < r * r] = v
    out.append(m)
    ties = np.zeros((20, 40), np.uint8)   # equal areas
    for x in (2, 12, 22, 32):
        ties[4:10, x:x + 5] = 1
    out.append(ties)
    out.append(np.ones((7, 9), np.uint8))   # touches every border
    return out


@pytest.mark.parametrize('native', [True, False], ids=['cpp', 'python'])
@pytest.mark.parametrize('mode', list(_MODES), ids=lambda m: '/'.join(m))
def test_find_contours_equals_cv2(mode, native):
    for seed in range(3):
        for m in _masks(seed):
            want = cv2.findContours(m, *_MODES[mode])[0]
            got = C.find_contours(m, *mode, native=native)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_find_contours_rejects_unknown_modes():
    with pytest.raises(ValueError, match='unknown mode'):
        C.find_contours(np.ones((3, 3), np.uint8), 'list', 'simple')


@pytest.mark.parametrize('closed', [True, False])
def test_approx_poly_dp_equals_cv2(closed):
    rng = np.random.default_rng(int(closed))
    for _ in range(400):
        n = int(rng.integers(1, 40))
        pts = rng.integers(0, 30, (n, 1, 2)).astype(np.int32)
        if rng.random() < 0.5:   # a walk, as contours are
            pts = np.cumsum(rng.integers(-1, 2, (n, 1, 2)), 0).astype(np.int32)
        for eps in (0.7, 2.0):
            np.testing.assert_array_equal(D.approx_poly_dp(pts, eps, closed),
                                          cv2.approxPolyDP(pts, eps, closed))


def test_approx_poly_dp_of_traced_contours():
    for m in _masks(4):
        for contour in cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]:
            np.testing.assert_array_equal(D.approx_poly_dp(contour, 0.7, True),
                                          cv2.approxPolyDP(contour, 0.7, True))


def test_equalize_hist_and_gray_equal_cv2():
    rng = np.random.default_rng(9)
    for t in range(30):
        g = rng.integers(0, 256, (37, 41), dtype=np.uint8)
        if t % 3 == 0:
            g = (g // 64 * 10 + 100).astype(np.uint8)
        if t == 1:
            g[:] = 77   # one value
        np.testing.assert_array_equal(D.equalize_hist(g), cv2.equalizeHist(g))
        c = rng.integers(0, 256, (20, 21, 3), dtype=np.uint8)
        np.testing.assert_array_equal(D.rgb_to_gray(c), cv2.cvtColor(c, cv2.COLOR_RGB2GRAY))
    assert math.isclose(D._SIN_TABLE[30], 0.5)


@pytest.mark.parametrize('native', [True, False], ids=['cpp', 'python'])
def test_approx_polygons_equal_cv2(native):
    rng = np.random.default_rng(11)
    contours = [rng.integers(0, 30, (int(n), 1, 2)).astype(np.int32)
                for n in rng.integers(1, 30, 200)]
    contours += [c for m in _masks(5) for c in
                 cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]]
    for closed in (True, False):
        for eps in (0.7, 2.0):
            got = C.approx_polygons(contours, eps, closed, native=native)
            assert len(got) == len(contours)
            for g, c in zip(got, contours):
                np.testing.assert_array_equal(g, cv2.approxPolyDP(c, eps, closed))
    assert C.approx_polygons([], 0.7, True, native=native) == []
