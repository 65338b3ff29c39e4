"""octseg_torch.analyze.contours against cv2 5.0.

Both tracers (the host C++ build of csrc/contours.cc and its plain Python
version) must return what ``cv2.findContours(mask, cv2.RETR_EXTERNAL,
cv2.CHAIN_APPROX_SIMPLE)[0]`` returns, element for element: the same
contours in the same order, each the same int32 (N, 1, 2) points in the same
order. ``contour_area`` and ``contour_moments`` must equal ``cv2.contourArea``
and ``cv2.moments`` to the bit, and so the centroid ``int(m10 / m00)``.
Tolerance: none anywhere.
"""

import cv2
import numpy as np
import pytest

from octseg_torch.analyze import contours as C
from tests.torch_threads import torch_threads_share  # noqa: F401


def _disc(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _cases():
    cases = {}
    m = np.zeros((12, 14), bool)
    m[3:8, 2:9] = True
    cases['block'] = m
    m = np.zeros((9, 9), bool)
    m[1:4, 1:4] = True
    cases['3x3 block'] = m
    cases['blob'] = _disc(40, 50, 20, 24, 11)
    cases['ring with a hole'] = _disc(40, 40, 20, 20, 15) & ~_disc(40, 40, 20, 20, 8)
    m = _disc(50, 50, 25, 25, 22) & ~_disc(50, 50, 25, 25, 15)
    m |= _disc(50, 50, 25, 25, 8)
    m[24:27, 24:27] = False
    cases['blob nested in a ring'] = m
    m = np.zeros((20, 20), bool)
    m[2:18, 2:18] = True
    m[3:17, 3:17] = False
    m[8:12, 8:12] = True
    cases['one-pixel ring around a blob'] = m
    m = np.zeros((15, 15), bool)
    for k in range(10):
        m[2 + k, 2 + k] = True
        m[2 + k, 12 - k] = True
    cases['diagonal-only chains'] = m
    m = np.zeros((10, 10), bool)
    m[4, 4] = True
    cases['one pixel'] = m
    m = np.zeros((10, 10), bool)
    m[4, 4:6] = True
    m[7, 2] = m[8, 3] = True
    cases['two-pixel objects'] = m
    m = np.zeros((16, 20), bool)
    m[3, 2:18] = True
    m[5:14, 9] = True
    cases['lines one pixel wide'] = m
    m = np.zeros((12, 12), bool)
    m[0, 3:8] = True
    m[4:8, 0] = True
    m[11, 2:6] = True
    m[3:9, 11] = True
    cases['touching each border'] = m
    m = np.zeros((10, 10), bool)
    m[0:2, 0:2] = m[0:3, 8:10] = m[8:10, 0] = m[9, 9] = True
    cases['touching each corner'] = m
    cases['all set'] = np.ones((7, 9), bool)
    cases['empty'] = np.zeros((7, 9), bool)
    m = np.zeros((20, 30), bool)
    m[2:7, 3:8] = True
    m[12:17, 20:25] = True
    m[3:8, 15:20] = True
    cases['three contours of equal area'] = m
    m = np.zeros((16, 16), bool)
    m[2:6, 2:6] = True
    m[6:10, 6:10] = True   # touches the first at a corner: one 8-connected object
    cases['corner-touching blocks'] = m
    m = np.zeros((16, 16), bool)
    m[1:15, 1:15] = True
    m[4:12, 4:12] = False
    m[5:11, 5:11] = True
    m[7:9, 7:9] = False
    cases['blob with a hole inside a ring'] = m
    return cases


CASES = _cases()


def _cv2(mask):
    return cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]


def assert_same_contours(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('native', [True, False], ids=['cpp', 'python'])
@pytest.mark.parametrize('scale', [1, 255])
@pytest.mark.parametrize('name', list(CASES))
def test_tracer_equals_cv2(name, scale, native):
    mask = CASES[name].astype(np.uint8) * scale
    assert_same_contours(C.find_external_contours(mask, native=native), _cv2(mask))


def test_equal_areas_tie_goes_to_the_contour_found_last():
    mask = CASES['three contours of equal area'].astype(np.uint8)
    got = C.find_external_contours(mask)
    areas = [C.contour_area(c) for c in got]
    assert len(set(areas)) == 1
    # cv2 lists the contours last found first; max() keeps the first maximum
    assert max(got, key=C.contour_area)[0, 0].tolist() == [20, 12]
    assert max(_cv2(mask), key=cv2.contourArea)[0, 0].tolist() == [20, 12]


def test_first_point_and_direction():
    mask = CASES['3x3 block'].astype(np.uint8)
    (contour,) = C.find_external_contours(mask)
    assert contour.reshape(-1, 2).tolist() == [[1, 1], [1, 3], [3, 3], [3, 1]]
    (single,) = C.find_external_contours(CASES['one pixel'].astype(np.uint8))
    assert single.reshape(-1, 2).tolist() == [[4, 4]]
    assert C.contour_moments(single)['m00'] == 0.0


def _random_masks(seed, n, size=64):
    rng = np.random.default_rng(seed)
    for i in range(n):
        if i % 2:
            mask = rng.random((size, size)) < rng.uniform(0.05, 0.95)
        else:
            mask = np.zeros((size, size), bool)
            for _ in range(rng.integers(1, 7)):
                cy, cx = rng.integers(0, size, 2)
                r = rng.integers(1, 20)
                disc = _disc(size, size, cy, cx, r)
                mask = (mask & ~disc) if rng.random() < 0.3 else (mask | disc)
        yield mask.astype(np.uint8) * (255 if i % 3 else 1)


@pytest.mark.parametrize('seed', range(4))
def test_random_64x64_masks(seed):
    for mask in _random_masks(seed, 60):
        want = _cv2(mask)
        assert_same_contours(C.find_external_contours(mask), want)
        assert_same_contours(C.find_external_contours(mask, native=False), want)
        for contour in want:
            assert C.contour_area(contour) == cv2.contourArea(contour)
            got, ref = C.contour_moments(contour), cv2.moments(contour)
            for key in ('m00', 'm10', 'm01'):
                assert got[key] == ref[key]


def lumen_mask(size=1000, seed=0):
    """A lumen-like 0/255 mask: a wobbly disc off centre, a catheter shadow
    cut into it and a small detached blob."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    theta = np.arctan2(yy - 480, xx - 530)
    radius = 260 + 25 * np.sin(3 * theta) + 10 * np.cos(7 * theta + rng.uniform(0, 6))
    mask = np.hypot(yy - 480, xx - 530) < radius
    mask &= ~((np.abs(yy - 480 - 0.3 * (xx - 530)) < 12) & (xx > 600))
    mask |= _disc(size, size, 850, 150, 30)
    return mask.astype(np.uint8) * 255


def test_lumen_like_1000x1000():
    mask = lumen_mask()
    want = _cv2(mask)
    assert len(want) == 2 and max(len(c) for c in want) > 500
    for native in (True, False):
        assert_same_contours(C.find_external_contours(mask, native=native), want)


@pytest.mark.parametrize('name', ['blob', 'ring with a hole', 'lines one pixel wide',
                                  'touching each corner', 'one pixel', 'all set'])
def test_area_and_moments_to_the_bit(name):
    for contour in _cv2(CASES[name].astype(np.uint8)):
        assert C.contour_area(contour) == cv2.contourArea(contour)
        got, ref = C.contour_moments(contour), cv2.moments(contour)
        assert (got['m00'], got['m10'], got['m01']) == (ref['m00'], ref['m10'], ref['m01'])
        if ref['m00']:
            assert int(got['m10'] / got['m00']) == int(ref['m10'] / ref['m00'])
            assert int(got['m01'] / got['m00']) == int(ref['m01'] / ref['m00'])


def test_clockwise_contour_moments():
    """cv2's traced contours are counterclockwise; a clockwise one takes the
    negative constants and gives the same moments."""
    contour = _cv2(CASES['blob'].astype(np.uint8))[0]
    reverse = np.ascontiguousarray(contour[::-1])
    ref = cv2.moments(reverse)
    got = C.contour_moments(reverse)
    assert (got['m00'], got['m10'], got['m01']) == (ref['m00'], ref['m10'], ref['m01'])
    assert C.contour_area(reverse) == cv2.contourArea(reverse)


def test_failed_build_raises_and_never_falls_back(monkeypatch):
    from octseg_torch.ops.kernels import _build

    def broken(name):
        raise RuntimeError(f'g++ failed for csrc/{name}.cc')

    monkeypatch.setattr(_build, 'load_host', broken)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed for csrc/contours.cc'):
        C.find_external_contours(CASES['blob'].astype(np.uint8))


def test_rejects_masks_that_are_not_2d():
    with pytest.raises(ValueError, match='2-D'):
        C.find_external_contours(np.zeros((4, 4, 3), np.uint8))
