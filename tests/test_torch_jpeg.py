"""octseg_torch's JPEG decoder (data/jpeg.py) against libjpeg-turbo, as PIL
and cv2 call it, and its JPEG DICOM frames against the JAX package's.

Both entropy decoders, the C++ one (csrc/jpeg_entropy.cc, built here with
g++; its cases skip only where no g++ is on PATH) and its plain Python
version, must give exactly PIL's ``Image.open`` and cv2's ``imdecode``
(BGR flipped) on every case: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, gray,
sizes that are not multiples of 8 or 16, quality 50/75/95, optimised
Huffman tables, restart intervals, an Adobe-marker RGB stream and one that
says RGB by its component ids only. An arithmetic-coded stream, which cv2
decodes, raises NotImplementedError; 12-bit and malformed lossless streams,
which cv2 refuses too, raise UndecodableJPEG. Progressive, lossless and
CMYK streams are in tests/test_torch_jpeg_forms.py.

``write_fixture`` wrote ``tests/torch_fixtures/jpeg/`` (with cv2 5.0 and
Pillow 12.1): a JPEG Baseline DICOM pullback of 16 OCT-like 704x704 colour
frames at 4:2:0, and small JPEGs at 4:4:4, 4:2:2, 4:4:0 (h1v2), gray and
with a restart interval. The card's machine has neither PIL nor cv2, so
chip_smoke.py reads these files; the tests hold them against PIL and cv2,
not against a fresh encode.
"""

import io
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from octseg.data import dicom as jax_dicom
from octseg_torch.data import dicom
from octseg_torch.data.jpeg import UndecodableJPEG, decode_jpeg
from octseg_torch.ops.kernels import _build
from tests.jpeg_streams import write_encapsulated_dicom
from tests.torch_threads import torch_threads_share  # noqa: F401

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'torch_fixtures', 'jpeg')
PULLBACK = os.path.join(FIXTURE_DIR, 'pullback.dcm')
SMALL = ('444.jpg', '422.jpg', 'h1v2.jpg', 'gray.jpg', 'restart.jpg')
FRAMES, FRAME_PX = 16, 704


# --------------------------------- fixtures ---------------------------------

def oct_frames(n: int, size: int, seed: int) -> np.ndarray:
    """(n, size, size, 3) uint8: a bright ring (the vessel wall) around a
    dark lumen, moving slowly, with smooth speckle, in a sepia colour map."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        cy = size / 2 + 20 * np.sin(i / 5)
        cx = size / 2 + 20 * np.cos(i / 7)
        r = np.hypot(yy - cy, xx - cx)
        wall = 180 * np.exp(-((r - size / 4) / 25) ** 2)
        speckle = cv2.resize(rng.normal(0, 14, (size // 4, size // 4)).astype(np.float32),
                             (size, size), interpolation=cv2.INTER_LINEAR)
        g = np.clip(wall + 30 + speckle, 0, 255)
        frames[i] = np.clip(np.stack([g, 0.85 * g + 10, 0.6 * g], -1), 0, 255)
    return frames


def natural_image(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 RGB: smooth colour waves with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + k) * np.cos(yy / 11.0 - k)
                    for k in range(3)], -1) + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_jpeg_dicom(path: str, fragments_per_frame, rows: int, cols: int, spp: int,
                     n_frames=None, ts: str = jax_dicom.JPEG_BASELINE) -> None:
    """A DICOM file (explicit VR little endian) whose pixel data is
    encapsulated: an empty basic offset table, then each frame's fragments.
    ``n_frames`` None leaves NumberOfFrames out (a single-frame image)."""
    write_encapsulated_dicom(path, fragments_per_frame, rows, cols, spp, ts, n_frames)


def _cv2_jpeg(img_rgb: np.ndarray, *params) -> bytes:
    bgr = img_rgb[..., ::-1] if img_rgb.ndim == 3 else img_rgb
    ok, buf = cv2.imencode('.jpg', np.ascontiguousarray(bgr), list(params))
    assert ok
    return buf.tobytes()


def write_fixture(directory: str) -> None:
    """Write the committed fixture: ``pullback.dcm`` and the small JPEGs."""
    os.makedirs(directory, exist_ok=True)
    frames = oct_frames(FRAMES, FRAME_PX, seed=3)
    jpegs = [_cv2_jpeg(f, cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420) for f in frames]
    write_jpeg_dicom(os.path.join(directory, 'pullback.dcm'), [[j] for j in jpegs],
                     FRAME_PX, FRAME_PX, 3, n_frames=FRAMES)
    img = natural_image(61, 83, seed=1)
    small = {
        '444.jpg': _cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        '422.jpg': _cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        'h1v2.jpg': _cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        'gray.jpg': _cv2_jpeg(img[..., 1]),
        'restart.jpg': _cv2_jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
    }
    for name, data in small.items():
        with open(os.path.join(directory, name), 'wb') as f:
            f.write(data)


# ------------------------------ decoder cases -------------------------------

def _jpeg_cases():
    cases = {}
    img = natural_image(37, 53, seed=0)
    for sf in ('444', '422', '420', '440'):
        for q in (50, 75, 95):
            cases[f'{sf} q{q} 37x53'] = _cv2_jpeg(
                img, cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{sf}'))
    cases['411 37x53'] = _cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    cases['gray 33x41'] = _cv2_jpeg(natural_image(33, 41, seed=2)[..., 0])
    for h, w in ((1, 1), (5, 3), (17, 9), (64, 64)):
        cases[f'420 {h}x{w}'] = _cv2_jpeg(natural_image(h, w, seed=h), cv2.IMWRITE_JPEG_QUALITY,
                                          90)
    cases['optimised Huffman'] = _cv2_jpeg(img, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    cases['restart interval 3'] = _cv2_jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    cases['gray restart interval 1'] = _cv2_jpeg(img[..., 2], cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, 'JPEG', keep_rgb=True, quality=90)
    adobe = bio.getvalue()
    cases['Adobe RGB'] = adobe
    i = adobe.index(b'\xff\xee')
    (length,) = struct.unpack_from('>H', adobe, i + 2)
    cases['RGB by component ids'] = adobe[:i] + adobe[i + 2 + length:]
    return cases


CASES = _jpeg_cases()


@pytest.fixture
def native_ok():
    if shutil.which('g++') is None:
        pytest.skip('no g++ on PATH: the C++ entropy decoder cannot be built here')


@pytest.fixture(params=['native', 'python'])
def native(request):
    if request.param == 'native' and shutil.which('g++') is None:
        pytest.skip('no g++ on PATH: the C++ entropy decoder cannot be built here')
    return request.param == 'native'


def _references(data: bytes):
    pil = np.asarray(Image.open(io.BytesIO(data)))
    cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return pil, cv[..., ::-1] if cv.ndim == 3 else cv


@pytest.mark.parametrize('case', list(CASES))
def test_decoder_is_bit_exact_with_pil_and_cv2(case, native):
    data = CASES[case]
    pil, cv = _references(data)
    got = decode_jpeg(data, native=native)
    assert got.dtype == np.uint8 and got.shape == pil.shape == cv.shape
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, cv)


def test_unsupported_forms_raise():
    img = natural_image(16, 16, seed=4)
    baseline = _cv2_jpeg(img)
    sof = baseline.index(b'\xff\xc0')
    refused = {   # forms cv2 refuses too (imdecode returns None)
        '12-bit': baseline[:sof + 4] + b'\x0c' + baseline[sof + 5:],   # the precision byte
        'lossless with a DCT scan': baseline[:sof + 1] + b'\xc3' + baseline[sof + 2:],
    }
    for form, data in refused.items():
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None, form
        with pytest.raises(UndecodableJPEG):
            decode_jpeg(data, native=False)
    arithmetic = baseline[:sof + 1] + b'\xc9' + baseline[sof + 2:]
    assert cv2.imdecode(np.frombuffer(arithmetic, np.uint8), cv2.IMREAD_UNCHANGED) is not None
    with pytest.raises(NotImplementedError, match=r'ROADMAP.md, "JPEG forms and image modes'):
        decode_jpeg(arithmetic, native=False)
    with pytest.raises(ValueError, match='not a JPEG'):
        decode_jpeg(b'\x89PNG\r\n\x1a\n')


def test_failed_build_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    """The predict path's decoder is the C++ one: a build that fails raises
    instead of decoding in Python."""
    monkeypatch.setattr(_build, '_libs', {})
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(_build, 'find_gxx', lambda: shutil.which('false') or '/bin/false')
    with pytest.raises(RuntimeError, match='failed for csrc/jpeg_entropy.cc'):
        decode_jpeg(CASES['420 17x9'])


# ---------------------------- the committed fixture --------------------------

@pytest.mark.parametrize('name', SMALL)
def test_fixture_jpegs_are_bit_exact(name, native):
    with open(os.path.join(FIXTURE_DIR, name), 'rb') as f:
        data = f.read()
    pil, cv = _references(data)
    got = decode_jpeg(data, native=native)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, cv)


def test_fixture_pullback_matches_jax_dicom(native_ok):
    """The JAX package's ``pixel_array`` (cv2.imdecode per frame) equals the
    port's on the 16-frame 4:2:0 pullback; the plain Python entropy decoder
    gives the same on its first frames."""
    assert os.path.getsize(PULLBACK) < 2.5 * 2**20
    want = jax_dicom.dcmread(PULLBACK).pixel_array
    ds = dicom.dcmread(PULLBACK)
    got = ds.pixel_array
    assert got.shape == want.shape == (FRAMES, FRAME_PX, FRAME_PX, 3)
    np.testing.assert_array_equal(got, want)
    for k, frag in enumerate(ds.PixelData[:2]):
        np.testing.assert_array_equal(decode_jpeg(frag, native=False), want[k])


def test_single_frame_in_fragments_matches_jax(tmp_path, native_ok):
    img = natural_image(40, 56, seed=6)
    for spp, pixels in ((3, img), (1, img[..., 0])):
        data = _cv2_jpeg(pixels, cv2.IMWRITE_JPEG_QUALITY, 80)
        cut = (len(data) // 3) & ~1
        path = str(tmp_path / f'IMG_{spp}')
        write_jpeg_dicom(path, [[data[:cut], data[cut:2 * cut], data[2 * cut:]]], 40, 56, spp)
        want = jax_dicom.dcmread(path).pixel_array
        got = dicom.dcmread(path).pixel_array
        assert got.shape == want.shape == ((40, 56, 3) if spp == 3 else (40, 56))
        np.testing.assert_array_equal(got, want)


def test_jpeg_dicom_faults(tmp_path):
    data = _cv2_jpeg(natural_image(16, 16, seed=7))
    path = str(tmp_path / 'IMG_2')
    write_jpeg_dicom(path, [[data], [data], [data]], 16, 16, 3, n_frames=2)
    with pytest.raises(dicom.DicomError, match='3 pixel-data fragments for 2 frames'):
        dicom.dcmread(path).pixel_array
    # the stream decides, not the transfer syntax: a baseline stream under
    # JPEG 2000's UID decodes, as cv2 decodes it for octseg
    write_jpeg_dicom(path, [[data]], 16, 16, 3, n_frames=1, ts='1.2.840.10008.1.2.4.90')
    np.testing.assert_array_equal(dicom.dcmread(path).pixel_array,
                                  jax_dicom.dcmread(path).pixel_array)
