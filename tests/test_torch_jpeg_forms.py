"""The JPEG forms octseg reads through cv2 and PIL, against both.

- Progressive streams that cv2 and PIL write here (gray, 4:4:4, 4:2:2,
  4:2:0 and h1v2; plain, with a restart interval, with optimised tables)
  decode bit-exact with ``cv2.imdecode`` and ``PIL.Image.open``; the
  committed progressive fixtures, which ``chip_smoke.py`` reads on the card,
  too.
- Lossless streams from ``tests/jpeg_streams.py`` (predictors 1-7, point
  transforms, 2 to 8 bits, 1, 3 and 4 components, restart intervals, one
  scan or one per component) decode bit-exact with cv2, and the 8-bit ones
  with PIL.
- CMYK streams decode as cv2 converts them (all 256 x 256 values of a
  channel and K, through a lossless stream) and as PIL holds them.
- Every other form either raises UndecodableJPEG where cv2 returns None too,
  or NotImplementedError naming the ROADMAP item where cv2 decodes it; a
  progressive script that leaves low coefficients unrefined (libjpeg-turbo
  smooths those blocks) is one of the latter.
- Every case runs through both entropy decoders, the C++ one and its plain
  Python version (the C++ cases skip only where no g++ is on PATH).
- DICOMs wrapping each form under the transfer syntaxes .50, .51, .57,
  .70, .5, .80 and .90: ``pixel_array`` equals octseg's, or raises the same
  exception class, apart from JPEG 2000, which octseg decodes and the port
  does not yet.
- The image-directory predict path with a 16-bit gray PNG, CMYK JPEGs and
  progressive and lossless JPEGs against octseg's.
"""

import io
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from octseg.core.config import Config as JaxConfig
from octseg.data import dicom as jax_dicom
from octseg.infer import predict as jax_predict
from octseg_torch.core.config import Config
from octseg_torch.data import dicom
from octseg_torch.data.image import open_image
from octseg_torch.data.jpeg import UndecodableJPEG, decode_jpeg, decode_jpeg_pil
from octseg_torch.infer import predict
from tests import jpeg_streams as js
from tests.test_torch_jpeg import FIXTURE_DIR, natural_image, oct_frames, write_jpeg_dicom
from tests.test_torch_predict import REACH, _dilate
from tests.test_torch_predict_images import CLASSES, NEAR, OUT, _jax_image_probabilities
from tests.test_torch_predict_images import models_dir  # noqa: F401 (a module fixture)
from tests.torch_threads import torch_threads_share  # noqa: F401

ROADMAP = r'ROADMAP.md, "JPEG forms and image modes'
PROGRESSIVE_FIXTURES = ('progressive_420_restart.jpg', 'progressive_444.jpg',
                        'progressive_gray.jpg', 'progressive_704.jpg')


@pytest.fixture(params=['native', 'python'])
def native(request):
    if request.param == 'native' and shutil.which('g++') is None:
        pytest.skip('no g++ on PATH: the C++ entropy decoder cannot be built here')
    return request.param == 'native'


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img is not None and img.ndim == 3 else img


def _pil(data: bytes) -> Image.Image:
    img = Image.open(io.BytesIO(data))
    img.load()
    return img


def _cv2_progressive(img, sampling, *params):
    bgr = img[..., ::-1] if img.ndim == 3 else img
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *params]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}')]
    ok, buf = cv2.imencode('.jpg', np.ascontiguousarray(bgr), params)
    assert ok
    return buf.tobytes()


def _pil_jpeg(img, mode=None, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, 'JPEG', **kw)
    return bio.getvalue()


def write_progressive_fixtures(directory: str) -> None:
    """Write the committed progressive JPEGs (cv2 5.0, Pillow 12.1): three
    small ones and one 704x704 4:2:0 OCT-like frame."""
    img = natural_image(61, 83, seed=11)
    data = {
        'progressive_420_restart.jpg': _cv2_progressive(img, '420', cv2.IMWRITE_JPEG_RST_INTERVAL,
                                                        2),
        'progressive_444.jpg': _pil_jpeg(img, progressive=True, optimize=True, subsampling=0),
        'progressive_gray.jpg': _cv2_progressive(img[..., 1], None),
        # one pullback frame, for the card's ms per frame
        'progressive_704.jpg': _cv2_progressive(oct_frames(1, 704, seed=5)[0], '420',
                                                cv2.IMWRITE_JPEG_QUALITY, 85),
    }
    for name, blob in data.items():
        with open(os.path.join(directory, name), 'wb') as f:
            f.write(blob)


def _progressive_cases():
    img = natural_image(37, 53, seed=0)
    cases = {}
    for sf in ('444', '422', '420', '440'):
        cases[f'cv2 {sf}'] = _cv2_progressive(img, sf)
        cases[f'cv2 {sf} restart 3'] = _cv2_progressive(img, sf, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    cases['cv2 420 optimised q95'] = _cv2_progressive(img, '420', cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                      cv2.IMWRITE_JPEG_QUALITY, 95)
    cases['cv2 gray restart 1'] = _cv2_progressive(img[..., 0], None,
                                                   cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    for ss, name in ((0, '444'), (1, '422'), (2, '420')):
        cases[f'PIL {name} optimised restart'] = _pil_jpeg(
            img, progressive=True, optimize=True, subsampling=ss, restart_marker_blocks=5)
    cases['PIL gray q50'] = _pil_jpeg(img[..., 2], progressive=True, quality=50)
    cases['PIL 420 17x9'] = _pil_jpeg(natural_image(17, 9, seed=3), progressive=True)
    return cases


def _lossless_cases():
    rng = np.random.default_rng(5)
    img = natural_image(23, 29, seed=4)
    cases = {f'predictor {p}': js.encode_lossless(img[..., 1], predictor=p) for p in range(1, 8)}
    cases['predictor 4, Pt 2'] = js.encode_lossless(img[..., 0], predictor=4, pt=2)
    cases['predictor 6, restart 5 rows'] = js.encode_lossless(img[..., 2], predictor=6,
                                                              restart_rows=5)
    for ids in ((1, 2, 3), (0, 1, 2), (82, 71, 66)):
        cases[f'RGB ids {ids}, predictor 7'] = js.encode_lossless(img, predictor=7, ids=ids)
    cases['RGB Adobe 0, restart 1 row, Pt 1'] = js.encode_lossless(img, predictor=5, pt=1,
                                                                   restart_rows=1, adobe=0)
    cases['RGB one scan per component'] = js.encode_lossless(img, predictor=3, scans='separate')
    for p in (2, 5, 7):
        cases[f'{p}-bit gray'] = js.encode_lossless(rng.integers(0, 1 << p, (11, 13)),
                                                    predictor=4, precision=p)
    cases['extreme differences'] = js.encode_lossless(
        np.where(rng.random((9, 31, 3)) < 0.5, 0, 255).astype(np.uint8), predictor=4)
    cases['CMYK, predictor 2'] = js.encode_lossless(rng.integers(0, 256, (9, 11, 4)),
                                                    predictor=2)
    return cases


def _cmyk_cases():
    rng = np.random.default_rng(6)
    cmyk = rng.integers(0, 256, (20, 24, 4), dtype=np.uint8)
    x, k = np.meshgrid(np.arange(256), np.arange(256))
    every = np.stack([x, 255 - x, (x * 7) % 256, k], -1).astype(np.uint8)
    return {
        'PIL CMYK': _pil_jpeg(cmyk, 'CMYK'),
        'PIL CMYK progressive': _pil_jpeg(cmyk, 'CMYK', progressive=True),
        'DC-only CMYK, no Adobe marker': js.encode_dc_only(rng.integers(-100, 100, (3, 4, 4))),
        'lossless CMYK, every C and K': js.encode_lossless(every, adobe=0),
    }


PROGRESSIVE = _progressive_cases()
LOSSLESS = _lossless_cases()
CMYK = _cmyk_cases()
DECODED = {**{f'progressive {k}': v for k, v in PROGRESSIVE.items()},
           **{f'lossless {k}': v for k, v in LOSSLESS.items()},
           **{f'CMYK {k}': v for k, v in CMYK.items()}}


@pytest.mark.parametrize('case', list(DECODED))
def test_forms_decode_bit_exact_with_cv2(case, native):
    data = DECODED[case]
    want = _cv2(data)
    assert want is not None
    got = decode_jpeg(data, native=native)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# the 8-bit forms PIL reads, and what it reads them as
PIL_CASES = [k for k in DECODED if '-bit gray' not in k]


@pytest.mark.parametrize('case', PIL_CASES)
def test_forms_decode_as_pil_holds_them(case):
    data = DECODED[case]
    want = _pil(data)
    mode, got = decode_jpeg_pil(data)
    assert mode == want.mode
    np.testing.assert_array_equal(got, np.asarray(want))


def test_pil_refuses_lossless_below_8_bits_as_the_port_does():
    data = LOSSLESS['5-bit gray']
    with pytest.raises(Image.UnidentifiedImageError):
        _pil(data)
    with pytest.raises(UndecodableJPEG, match='PIL reads 8-bit samples only'):
        decode_jpeg_pil(data)


@pytest.mark.parametrize('name', PROGRESSIVE_FIXTURES)
def test_progressive_fixtures_are_bit_exact(name, native):
    with open(os.path.join(FIXTURE_DIR, name), 'rb') as f:
        data = f.read()
    assert data[data.index(b'\xff\xc2') + 1] == 0xC2
    np.testing.assert_array_equal(decode_jpeg(data, native=native), _cv2(data))
    np.testing.assert_array_equal(decode_jpeg_pil(data)[1], np.asarray(_pil(data)))


def _refused_forms():
    """Forms cv2 refuses too."""
    img = natural_image(16, 24, seed=8)
    baseline = cv2.imencode('.jpg', img)[1].tobytes()
    dc = np.random.default_rng(9).integers(-100, 100, (2, 3))
    lossless = js.encode_lossless(img[..., 0], restart_rows=2)
    rst = lossless.index(b'\xff\xdd')
    forms = {f'SOF{m - 0xC0}': js.set_frame_marker(baseline, m)
             for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)}
    forms.update({
        'arithmetic lossless (SOF11)': js.set_frame_marker(lossless, 0xCB),
        'JPEG-LS (SOF55)': js.set_frame_marker(baseline, 0xF7),
        '12-bit lossless': js.encode_lossless(img[..., 0].astype(np.uint16) << 4,
                                              precision=12),
        '16-bit lossless': js.encode_lossless(img[..., 0].astype(np.uint16) << 8,
                                              precision=16),
        '12-bit DCT (SOF1), DC only': js.encode_dc_only(dc * 16, precision=12),
        '2 components': js.encode_dc_only(np.stack([dc, dc], -1)),
        'lossless with a JFIF marker (YCbCr)': js.encode_lossless(img, jfif=True),
        'lossless CMYK with Adobe transform 2 (YCCK)': js.encode_lossless(
            np.dstack([img, img[..., :1]]), adobe=2),
        'lossless restart of part of a row': lossless[:rst + 4] + b'\x00\x19' + lossless[rst + 6:],
    })
    return forms


def _not_yet_forms():
    """Forms cv2 decodes and the port does not yet."""
    img = natural_image(40, 48, seed=10)
    baseline = cv2.imencode('.jpg', img)[1].tobytes()
    progressive = _cv2_progressive(img, '420')
    cmyk = _pil_jpeg(np.dstack([img, img[..., :1]]), 'CMYK')
    lossless = js.encode_lossless(img)
    sampling = lossless.index(b'\xff\xc3') + 11   # the first component's h, v byte
    return {
        'arithmetic (SOF9)': (js.set_frame_marker(baseline, 0xC9), 'arithmetic'),
        'arithmetic progressive (SOF10)': (js.set_frame_marker(progressive, 0xCA), 'arithmetic'),
        'YCCK (Adobe transform 2)': (js.set_adobe_transform(cmyk, 2), 'YCCK'),
        'YCCK (Adobe transform 1)': (js.set_adobe_transform(cmyk, 1), 'YCCK'),
        'progressive DC scans only': (js.first_scans(progressive, 2), 'smooths'),
        'progressive without its last scans': (js.first_scans(progressive, 8), 'smooths'),
        'lossless with 2x2 sampled luma': (
            lossless[:sampling] + b'\x22' + lossless[sampling + 1:], 'subsampled'),
    }


REFUSED = _refused_forms()
NOT_YET = _not_yet_forms()


@pytest.mark.parametrize('form', list(REFUSED))
def test_forms_cv2_refuses_raise_undecodable(form):
    data = REFUSED[form]
    assert _cv2(data) is None
    for native in (False, True):
        with pytest.raises(UndecodableJPEG):
            decode_jpeg(data, native=native)


@pytest.mark.parametrize('form', list(NOT_YET))
def test_forms_cv2_decodes_raise_not_implemented(form):
    data, what = NOT_YET[form]
    assert _cv2(data) is not None
    for native in (False, True):
        with pytest.raises(NotImplementedError, match=f'{what}.*{ROADMAP}'):
            decode_jpeg(data, native=native)


# ------------------------------------ DICOM -----------------------------------

def _j2k_codestream(img) -> bytes:
    """cv2's JPEG 2000 codestream (the contents of its JP2 file's jp2c box),
    as a .90 fragment holds it."""
    jp2 = cv2.imencode('.jp2', img)[1].tobytes()
    return jp2[jp2.index(b'jp2c') + 4:]


def _dicom_cases():
    img = natural_image(32, 40, seed=12)
    dc = np.random.default_rng(13).integers(-100, 100, (4, 5))
    return {
        'baseline .50': ('.4.50', [cv2.imencode('.jpg', img)[1].tobytes()] * 2, 3),
        'progressive .50': ('.4.50', [PROGRESSIVE['PIL 420 optimised restart'],
                                      PROGRESSIVE['cv2 420 restart 3']], 3),
        'CMYK .50': ('.4.50', [CMYK['PIL CMYK']], 3),
        '12-bit .51': ('.4.51', [js.encode_dc_only(dc * 16, precision=12)], 1),
        'lossless gray .57': ('.4.57', [LOSSLESS['predictor 4, Pt 2'], LOSSLESS['predictor 1']],
                              1),
        '12-bit lossless .57': ('.4.57', [REFUSED['12-bit lossless']], 1),
        'lossless RGB .70': ('.4.70', [js.encode_lossless(img, restart_rows=4)] * 3, 3),
        'RLE .5': ('.5', [b'\x01\x00\x00\x00' + b'\x40\x00\x00\x00' + bytes(56) + bytes(64)], 1),
        'JPEG-LS .80': ('.4.80', [REFUSED['JPEG-LS (SOF55)']], 3),
        'JPEG 2000 .90': ('.4.90', [_j2k_codestream(img[..., ::-1])], 3),
    }


TS_ROOT = '1.2.840.10008.1.2'
DICOM_CASES = _dicom_cases()


@pytest.mark.parametrize('case', list(DICOM_CASES))
def test_dicom_forms_match_octseg(tmp_path, case):
    suffix, frames, spp = DICOM_CASES[case]
    ts = TS_ROOT + suffix
    path = str(tmp_path / 'IMG')
    write_jpeg_dicom(path, [[f] for f in frames], 8, 8, spp, n_frames=len(frames), ts=ts)
    try:
        want = jax_dicom.dcmread(path).pixel_array
    except Exception as err:    # noqa: BLE001 - the class is what is compared
        want = err
    if case == 'JPEG 2000 .90':   # cv2 decodes it for octseg; the port does not yet
        assert isinstance(want, np.ndarray)
        with pytest.raises(NotImplementedError, match=f'JPEG 2000.*{ts}.*{ROADMAP}'):
            dicom.dcmread(path).pixel_array
        return
    if isinstance(want, Exception):
        assert isinstance(want, jax_dicom.DicomError) and 'Cannot decode frame' in str(want)
        with pytest.raises(dicom.DicomError, match=f'Cannot decode frame \\(transfer syntax {ts}'):
            dicom.dcmread(path).pixel_array
        return
    got = dicom.dcmread(path).pixel_array
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------- the image directory ----------------------------

def write_mode_dir(root: str) -> list:
    """A directory of the image forms this slice adds; returns the names."""
    os.makedirs(root, exist_ok=True)
    img = natural_image(70, 90, seed=14)
    wall = (img[..., 1].astype(np.uint16) * 180 + np.arange(90, dtype=np.uint16)[None] * 7)
    Image.fromarray(wall).save(os.path.join(root, 'a_gray16.png'))
    cmyk = np.dstack([255 - img, 255 - img[..., 1:2] // 2])
    for name, data in (('b_cmyk.jpg', _pil_jpeg(cmyk, 'CMYK', quality=90)),
                       ('c_cmyk_progressive.jpg', _pil_jpeg(cmyk, 'CMYK', progressive=True)),
                       ('d_progressive.jpg', _cv2_progressive(img, '420')),
                       ('e_lossless.jpg', js.encode_lossless(img, predictor=6))):
        with open(os.path.join(root, name), 'wb') as f:
            f.write(data)
    return ['a_gray16', 'b_cmyk', 'c_cmyk_progressive', 'd_progressive', 'e_lossless']


def test_image_directory_forms_predict_matches_jax(models_dir, tmp_path, monkeypatch):
    monkeypatch.setattr('octseg.core.config.setup_logging', lambda *a, **k: None)
    data_dir = str(tmp_path / 'images')
    names = write_mode_dir(data_dir)
    assert [open_image(os.path.join(data_dir, f)).mode for f in sorted(os.listdir(data_dir))] \
        == ['I;16', 'CMYK', 'CMYK', 'RGB', 'RGB']
    keys = dict(data_dir=data_dir, models_dir=models_dir, output_size=OUT, block_size=4,
                classes=CLASSES)
    jax_predict.main(JaxConfig(save_dir=str(tmp_path / 'jax'), device='auto', **keys))
    result = predict.main(Config(save_dir=str(tmp_path / 'torch'), device='cpu', **keys))
    assert result['frames'] == len(names)
    probs = _jax_image_probabilities(models_dir, data_dir)
    near = (np.abs(probs - 0.5) < NEAR).any(axis=-1)
    for i, name in enumerate(names):
        for kind, allowed in (('mask', near[i]), ('overlay', _dilate(near[i], REACH))):
            want = np.asarray(Image.open(tmp_path / 'jax' / f'{name}_{kind}.png'))
            got = np.asarray(Image.open(tmp_path / 'torch' / f'{name}_{kind}.png'))
            assert got.shape == want.shape == (*OUT, 3)
            differ = (got != want).any(axis=-1)
            assert not (differ & ~allowed).any(), f'{name}_{kind} differs away from p = 0.5'
