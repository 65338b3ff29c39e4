"""octseg_torch's host image work against PIL and cv2, which octseg uses.

The port composites and writes its PNGs without PIL or cv2
(octseg_torch/data/image.py); each function must give the exact bytes of the
library call it replaces.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from octseg_torch.data.image import (
    normalize_slice,
    paste_solid,
    pil_resize_bicubic,
    write_png,
)


@pytest.mark.parametrize('in_hw,out_wh', [
    ((704, 704), (1000, 1000)),   # the main path's frames to the default output
    ((750, 750), (512, 512)),     # a downscale (support widened)
    ((64, 64), (48, 40)),         # non-square output, (w, h) order
    ((100, 80), (100, 33)),       # one pass skipped
    ((30, 50), (50, 30)),
    ((5, 3), (17, 2)),
])
def test_pil_resize_bicubic_matches_pillow(in_hw, out_wh):
    img = np.random.default_rng(sum(in_hw)).integers(0, 256, (*in_hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out_wh))
    got = pil_resize_bicubic(img, out_wh)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_pil_resize_of_a_gray_frame_matches_convert_rgb():
    """The predict path's mono frames: PIL converts L to RGB, then resizes."""
    gray = np.random.default_rng(1).integers(0, 256, (40, 52), dtype=np.uint8)
    want = np.asarray(Image.fromarray(gray).convert('RGB').resize((61, 33)))
    got = pil_resize_bicubic(np.repeat(gray[..., None], 3, axis=-1), (61, 33))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('color', [(228, 30, 199), (0, 0, 0), (255, 255, 255)])
def test_paste_solid_matches_image_paste(color):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8)
    alpha = rng.integers(0, 256, (37, 45), dtype=np.uint8)
    alpha[:3] = 0
    alpha[-3:] = 255
    ref = Image.fromarray(img.copy())
    ref.paste(Image.new('RGB', (45, 37), color), (0, 0), Image.fromarray(alpha))
    np.testing.assert_array_equal(paste_solid(img.copy(), color, alpha), np.asarray(ref))


@pytest.mark.parametrize('shape', [(20, 31, 3), (20, 31), (1, 1, 3)])
def test_write_png_decodes_under_pil(tmp_path, shape):
    arr = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / 'x.png')
    write_png(path, arr)
    with Image.open(path) as im:
        assert im.mode == ('RGB' if len(shape) == 3 else 'L')
        np.testing.assert_array_equal(np.asarray(im), arr)


def test_write_png_rejects_other_layouts(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / 'x.png'), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / 'x.png'), np.zeros((4, 4), np.float32))


def _cv2_normalize(x):
    return cv2.normalize(x, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX,
                         dtype=cv2.CV_8U)


@pytest.mark.parametrize('dtype,lo,hi,shape', [
    (np.uint16, 100, 900, (64, 64)),
    (np.uint16, 30000, 60000, (64, 64)),
    (np.uint16, 0, 65535, (37, 53)),      # odd width: cv2's scalar tail
    (np.uint16, 7, 4000, (20, 20, 3)),
    (np.uint8, 3, 250, (33, 65)),
])
def test_normalize_slice_matches_cv2(dtype, lo, hi, shape):
    x = np.random.default_rng(hi).integers(lo, hi, shape).astype(dtype)
    np.testing.assert_array_equal(normalize_slice(x), _cv2_normalize(x))


def test_normalize_slice_of_a_constant_slice_is_zero():
    x = np.full((16, 16), 1234, np.uint16)
    np.testing.assert_array_equal(normalize_slice(x), _cv2_normalize(x))
    assert not normalize_slice(x).any()
