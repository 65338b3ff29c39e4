"""octseg_torch.analyze.analysis against octseg.analyze.analysis.

The same masks go through both packages' ``quantify_frame``,
``calculate_thickness_contour`` (both tracers of the port) and
``calculate_object_thickness``; every output must be equal as Python floats
(``==``, no tolerance), the measurement lists included.
"""

import cv2
import numpy as np
import pytest

from octseg.analyze import analysis as ref
from octseg_torch.analyze import analysis
from tests.test_torch_contours import CASES, lumen_mask


def _masks():
    out = {name: m.astype(np.uint8) * 255 for name, m in CASES.items()}
    out['lumen 1000x1000'] = lumen_mask()
    rng = np.random.default_rng(3)
    out['noise 64x64'] = (rng.random((64, 64)) < 0.4).astype(np.uint8) * 255
    return out


MASKS = _masks()


@pytest.mark.parametrize('native', [True, False], ids=['cpp', 'python'])
@pytest.mark.parametrize('name', list(MASKS))
def test_quantify_frame_equals_octseg(name, native):
    mask = MASKS[name]
    for ratio in (1, 7, 150):
        assert analysis.quantify_frame(mask, ratio, native=native) == ref.quantify_frame(
            mask, ratio)


@pytest.mark.parametrize('name', ['blob', 'ring with a hole', 'three contours of equal area',
                                  'lumen 1000x1000', 'one pixel', 'all set', 'empty'])
def test_thickness_contour_equals_octseg(name):
    mask = MASKS[name]
    got = analysis.calculate_thickness_contour(mask)
    assert got == ref.calculate_thickness_contour(mask)
    assert analysis.calculate_thickness_contour(mask, native=False) == got


@pytest.mark.parametrize('name', ['blob', 'ring with a hole', 'lumen 1000x1000', 'all set',
                                  'empty', 'touching each border'])
def test_object_thickness_equals_octseg(name):
    mask = MASKS[name]
    assert analysis.calculate_object_thickness(mask) == ref.calculate_object_thickness(mask)


def test_object_thickness_of_a_3_channel_mask():
    """A BGR mask goes through cv2's BGR2GRAY rounding first: near-white
    colours that round to 255 count as object, others do not."""
    mask = np.zeros((120, 140, 3), np.uint8)
    mask[20:100, 30:110] = 255
    mask[40:60, 30:110] = (254, 255, 255)   # gray 255: still object
    mask[60:70, 30:110] = (255, 254, 254)   # gray 254: a gap
    mask[70:75, 50:90] = (0, 0, 255)
    got = analysis.calculate_object_thickness(mask)
    assert got == ref.calculate_object_thickness(mask)
    assert got['all_measurements']


def test_bgr_to_gray_equals_cv2():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    img[0, :8] = [(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255),
                  (254, 255, 255), (1, 2, 3), (128, 128, 128)]
    np.testing.assert_array_equal(analysis.bgr_to_gray_u8(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
