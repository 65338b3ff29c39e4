"""octseg_torch's host data path against the JAX package's and cv2's.

The port decodes and resizes without cv2 and without octseg.native: its
TIFF codec, PNG reader and cv2-exact resizes must give the JAX package's
arrays bit for bit, and its dataset, loader and synthetic folds the same
batches.
"""

import os
import struct
import time
import zlib

import cv2
import numpy as np
import pytest

from octseg.data import synth as jax_synth
from octseg.data import tiffio as jax_tiffio
from octseg.train import data as jax_data
from octseg_torch.data import synth, tiffio
from octseg_torch.data.image import read_png, resize_linear_u8, resize_nearest_u8
from octseg_torch.train import data


def _masks(rng, h, w, c):
    """Blocky {0,255} masks, as the dataset's TIFFs hold."""
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((h, w, c), np.uint8)
    for k in range(c):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(2, max(h, w) // 2)
        out[..., k] = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r, 255, 0)
    return out


@pytest.mark.parametrize('compression', ['lzw', 'deflate', 'none'])
@pytest.mark.parametrize('shape', [(37, 53, 4), (64, 64, 2), (20, 31)])
def test_tiff_round_trips_with_jax(tmp_path, compression, shape):
    rng = np.random.default_rng(sum(shape))
    arr = _masks(rng, shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
    arr = arr.reshape(shape)
    arr[::7] = rng.integers(0, 256, arr[::7].shape)   # some noise for LZW's table
    ours, theirs = str(tmp_path / 'port.tiff'), str(tmp_path / 'jax.tiff')
    tiffio.write_tiff(ours, arr, compression=compression)
    jax_tiffio.write_tiff(theirs, arr, compression=compression)
    np.testing.assert_array_equal(jax_tiffio.read_tiff(ours), arr)
    np.testing.assert_array_equal(tiffio.read_tiff(theirs), arr)
    with open(ours, 'rb') as f, open(theirs, 'rb') as g:
        assert f.read() == g.read()


@pytest.mark.parametrize('n', [0, 1, 300, 70000])
def test_lzw_encoder_emits_the_jax_codes(n):
    """The port keys its table by integers; the codes must be octseg's,
    table resets (past 4094 entries) included."""
    data = np.random.default_rng(n).integers(0, 5, n, dtype=np.uint8).tobytes()
    assert tiffio.lzw_encode(data) == jax_tiffio._lzw_encode(data)
    assert tiffio.lzw_decode(tiffio.lzw_encode(data)) == data


def _tiff_bytes(arr, byteorder, predictor, compression):
    """A hand-made single-strip TIFF with a predictor tag, in either byte
    order (octseg's writer makes neither)."""
    h, w, spp = arr.shape
    data = arr.astype(np.uint8)
    if predictor == 2:
        data = np.diff(data.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    payload = data.tobytes()
    comp = {'none': 1, 'deflate': 8, 'lzw': 5}[compression]
    if compression == 'deflate':
        payload = zlib.compress(payload)
    elif compression == 'lzw':
        payload = jax_tiffio._lzw_encode(payload)
    bo = '<' if byteorder == 'II' else '>'
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp), (259, 3, [comp]),
            (262, 3, [1]), (273, 4, [0]), (277, 3, [spp]), (278, 4, [h]),
            (279, 4, [len(payload)]), (284, 3, [1]), (317, 3, [predictor])]
    ifd_size = 2 + 12 * len(tags) + 4
    extra = b''
    entries = b''
    data_pos = 8 + ifd_size + 2 * spp
    for tag, typ, vals in tags:
        fmt = {3: 'H', 4: 'I'}[typ]
        packed = struct.pack(bo + str(len(vals)) + fmt, *vals)
        if tag == 273:
            packed = struct.pack(bo + 'I', data_pos)
        if len(packed) <= 4:
            field = packed.ljust(4, b'\0')
        else:
            field = struct.pack(bo + 'I', 8 + ifd_size + len(extra))
            extra += packed
        entries += struct.pack(bo + 'HHI', tag, typ, len(vals)) + field
    extra = extra.ljust(2 * spp, b'\0')
    head = byteorder.encode() + struct.pack(bo + 'HI', 42, 8)
    return (head + struct.pack(bo + 'H', len(tags)) + entries + struct.pack(bo + 'I', 0)
            + extra + payload)


@pytest.mark.parametrize('byteorder', ['II', 'MM'])
@pytest.mark.parametrize('predictor', [1, 2])
@pytest.mark.parametrize('compression', ['lzw', 'deflate', 'none'])
def test_read_tiff_predictor_and_byte_order_match_jax(tmp_path, byteorder, predictor,
                                                      compression):
    arr = np.random.default_rng(predictor).integers(0, 256, (23, 41, 3), dtype=np.uint8)
    path = str(tmp_path / 'x.tiff')
    with open(path, 'wb') as f:
        f.write(_tiff_bytes(arr, byteorder, predictor, compression))
    want = jax_tiffio.read_tiff(path)
    np.testing.assert_array_equal(want, arr)
    np.testing.assert_array_equal(tiffio.read_tiff(path), want)


def _test_image(h, w, c):
    """Gradients, rings and noise rows: every PNG row filter wins somewhere."""
    yy, xx = np.mgrid[:h, :w]
    planes = [(xx // 3 + yy // 5) % 256, (xx * yy // 97) % 256,
              ((xx - w // 2) ** 2 + (yy - h // 2) ** 2) // 900 % 256, (xx + 2 * yy) % 256]
    img = np.stack(planes[:c], -1).astype(np.uint8)
    img[::17] = np.random.default_rng(h).integers(0, 256, img[::17].shape)
    return img[..., 0] if c == 1 else img


def _png_chunk(tag, body):
    return struct.pack('>I', len(body)) + tag + body + struct.pack('>I', zlib.crc32(tag + body))


def _encode_png(samples, depth, color, interlace=False, plte=None, trns=None):
    """A PNG of integer ``samples`` (H, W, samples per pixel), written here
    and not by cv2: any colour type and bit depth, optionally Adam7, the
    rows of each pass cycling through all five filter types."""
    h, w, spp = samples.shape
    bpp = max(1, spp * depth // 8)

    def pass_bytes(s):
        flat = s.reshape(s.shape[0], -1).astype(np.int64)
        if depth == 16:
            rows = np.stack([flat >> 8, flat & 255], -1).reshape(len(flat), -1)
        elif depth == 8:
            rows = flat
        else:
            per = 8 // depth
            padded = np.zeros((len(flat), -(-flat.shape[1] // per) * per), np.int64)
            padded[:, :flat.shape[1]] = flat
            shifts = np.arange(8 - depth, -1, -depth)
            rows = (padded.reshape(len(flat), -1, per) << shifts).sum(-1)
        out, prev = b'', np.zeros(rows.shape[1], np.int64)
        for i, r in enumerate(rows):
            left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            pred = [0 * r, left, prev, (left + prev) // 2, paeth][i % 5]
            out += bytes([i % 5]) + ((r - pred) & 255).astype(np.uint8).tobytes()
            prev = r
        return out

    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)])
    raw = b''.join(pass_bytes(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                   if x0 < w and y0 < h)
    return (b'\x89PNG\r\n\x1a\n'
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, color, 0, 0, interlace))
            + (_png_chunk(b'PLTE', plte.astype(np.uint8).tobytes()) if plte is not None else b'')
            + (_png_chunk(b'tRNS', trns) if trns is not None else b'')
            + _png_chunk(b'IDAT', zlib.compress(raw)) + _png_chunk(b'IEND', b''))


# PNGs cv2 writes: (samples per pixel, size, filters)
_CV2_WRITTEN = [(c, size, filters) for filters in ('default', 'all') for size in (64, 1000)
                for c in (1, 3, 4)]
# hand-made PNGs: (colour type, bit depth, Adam7); palettes have one entry
# fewer than their index range (the last index reads black) and a tRNS chunk
_ENCODED = [(3, 1, 0), (3, 2, 0), (3, 4, 0), (3, 8, 0), (0, 16, 0), (2, 16, 0), (4, 16, 0),
            (6, 16, 0), (0, 1, 0), (0, 2, 0), (0, 4, 0), (2, 8, 1), (6, 16, 1), (3, 2, 1),
            (0, 1, 1), (4, 8, 1)]
_COLOR_NAMES = {0: 'gray', 2: 'rgb', 3: 'palette', 4: 'gray_alpha', 6: 'rgba'}


@pytest.mark.parametrize('case', [('cv2', *c) for c in _CV2_WRITTEN]
                         + [('encoded', *c) for c in _ENCODED],
                         ids=[f'{f}-{s}-{c}' for c, s, f in _CV2_WRITTEN]
                         + [f'{_COLOR_NAMES[c]}-{d}bit' + ('-adam7' if i else '')
                            for c, d, i in _ENCODED])
def test_read_png_matches_cv2_imread(tmp_path, case):
    path = str(tmp_path / 'x.png')
    if case[0] == 'cv2':
        _, channels, size, filters = case
        img = _test_image(size, size, channels)
        params = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS] if filters == 'all' else []
        assert cv2.imwrite(path, img, params)
        shape = (size, size, 3)
    else:
        _, color, depth, interlace = case
        spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
        # 37 x 53: every Adam7 pass is non-empty and no row ends on a byte
        shape = (37, 53, 3)
        rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
        samples = rng.integers(0, 1 << depth, (37, 53, spp))
        plte = rng.integers(0, 256, ((1 << depth) - 1, 3)) if color == 3 else None
        with open(path, 'wb') as f:
            f.write(_encode_png(samples, depth, color, interlace, plte,
                                b'\x00\x80' if color == 3 else None))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, cv2.imread(path))


def test_read_png_all_five_filters_and_speed(tmp_path):
    """A 1000x1000 BGR frame whose rows use all five filter types decodes
    exactly, in under 0.5 s (the best of three runs)."""
    img = _test_image(1000, 1000, 3)
    path = str(tmp_path / 'x.png')
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    with open(path, 'rb') as f:
        buf = f.read()
    pos, idat = 8, b''
    while pos < len(buf):
        (n,) = struct.unpack_from('>I', buf, pos)
        if buf[pos + 4:pos + 8] == b'IDAT':
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(1000, -1)
    assert set(np.unique(rows[:, 0]).tolist()) == {0, 1, 2, 3, 4}
    best = float('inf')
    for _ in range(3):
        t = time.perf_counter()
        got = read_png(path)
        best = min(best, time.perf_counter() - t)
    np.testing.assert_array_equal(got, cv2.imread(path))
    assert best < 0.5, best


@pytest.mark.parametrize('kind', ['colour 4:2:0', 'gray', 'exif orientation 6',
                                  'exif orientation 3'])
def test_read_png_reads_a_jpeg_as_cv2_imread(tmp_path, kind):
    """A JPEG in a folder that octseg reads with cv2.imread (IMREAD_COLOR):
    BGR, gray replicated, the EXIF orientation applied."""
    from PIL import Image

    rng = np.random.default_rng(21)
    img = np.clip(rng.normal(120, 40, (37, 50, 3)), 0, 255).astype(np.uint8)
    path = str(tmp_path / 'x.jpg')
    if kind.startswith('exif'):
        exif = Image.Exif()
        exif[0x0112] = int(kind[-1])
        Image.fromarray(img).save(path, 'JPEG', exif=exif.tobytes())
    else:
        cv2.imwrite(path, img[..., 0] if kind == 'gray' else img)
    want = cv2.imread(path)
    got = read_png(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_read_png_rejects_what_it_does_not_decode(tmp_path):
    path = str(tmp_path / 'x.jpg')
    cv2.imwrite(path, np.zeros((16, 16, 3), np.uint8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match='progressive.*ROADMAP.md'):
        read_png(path)
    with open(path, 'wb') as f:
        f.write(_encode_png(np.zeros((2, 2, 3), np.int64), 4, 2))   # RGB has no 4-bit form
    with pytest.raises(ValueError, match='bad PNG header'):
        read_png(path)
    with open(path, 'wb') as f:
        f.write(b'GIF89a')
    with pytest.raises(ValueError):
        read_png(path)


@pytest.mark.parametrize('in_hw,out_wh', [
    ((1000, 1000), (512, 512)), ((704, 704), (512, 512)), ((90, 100), (64, 64)),
    ((48, 48), (64, 64)), ((64, 64), (64, 64)), ((1024, 1024), (512, 512)),
    ((37, 53), (101, 29)), ((512, 512), (1000, 1000)),
])
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_resize_linear_u8_matches_cv2(in_hw, out_wh, channels):
    img = np.random.default_rng(sum(in_hw) + channels).integers(
        0, 256, (*in_hw, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    want = cv2.resize(img, out_wh)
    got = resize_linear_u8(img, out_wh)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('in_hw,out_wh', [((1000, 1000), (512, 512)), ((63, 70), (35, 57)),
                                          ((48, 48), (64, 64)), ((80, 80), (64, 64))])
def test_resize_nearest_u8_matches_cv2(in_hw, out_wh):
    img = np.random.default_rng(3).integers(0, 256, (*in_hw, 4), dtype=np.uint8)
    np.testing.assert_array_equal(resize_nearest_u8(img, out_wh),
                                  cv2.resize(img, out_wh, interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(resize_nearest_u8(img[..., :1], out_wh),
                                  cv2.resize(img[..., :1], out_wh,
                                             interpolation=cv2.INTER_NEAREST))


@pytest.fixture(scope='module')
def jax_fold(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_fold'))
    jax_synth.make_synth_fold(root, n_train=10, n_test=3, size=100, seed=5, n_vis=1)
    return root


def test_synth_fold_decodes_to_the_jax_arrays(tmp_path, jax_fold):
    ours = str(tmp_path / 'fold')
    synth.make_synth_fold(ours, n_train=10, n_test=3, size=100, seed=5, n_vis=1)
    for split in ('train', 'test', 'vis'):
        for kind in ('img', 'mask'):
            names = sorted(os.listdir(os.path.join(jax_fold, split, kind)))
            assert sorted(os.listdir(os.path.join(ours, split, kind))) == names
            for name in names:
                a, b = (os.path.join(root, split, kind, name) for root in (ours, jax_fold))
                if kind == 'img':
                    np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
                else:
                    np.testing.assert_array_equal(jax_tiffio.read_tiff(a),
                                                  jax_tiffio.read_tiff(b))


@pytest.mark.parametrize('classes', [['Lumen'], ['Lipid core', 'Vasa vasorum']])
def test_dataset_load_matches_jax(jax_fold, classes):
    ours = data.OCTDataset(os.path.join(jax_fold, 'train'), classes, input_size=64)
    theirs = jax_data.OCTDataset(os.path.join(jax_fold, 'train'), classes, input_size=64)
    assert ours.img_paths == theirs.img_paths and ours.mask_paths == theirs.mask_paths
    for i in range(len(ours)):
        (a_img, a_mask), (b_img, b_mask) = ours.load(i), theirs.load(i)
        assert a_img.dtype == np.float32 and a_mask.dtype == np.float32
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_mask, b_mask)


def test_prefetch_loader_batches_match_jax_over_two_epochs(jax_fold):
    ours = data.PrefetchLoader(data.OCTDataset(os.path.join(jax_fold, 'train'), ['Lumen'], 64),
                               4, shuffle=True, drop_last=True, seed=11)
    theirs = jax_data.PrefetchLoader(
        jax_data.OCTDataset(os.path.join(jax_fold, 'train'), ['Lumen'], 64),
        4, shuffle=True, drop_last=True, seed=11)
    assert len(ours) == len(theirs) == 2
    for _epoch in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for (a_img, a_mask), (b_img, b_mask) in zip(got, want):
            np.testing.assert_array_equal(a_img, b_img)
            np.testing.assert_array_equal(a_mask, b_mask)
    val = list(data.PrefetchLoader(data.OCTDataset(os.path.join(jax_fold, 'test'), ['Lumen'],
                                                   64), 2))
    assert [b[0].shape[0] for b in val] == [2, 1]


def test_dataset_filters_pairs_without_the_classes(tmp_path):
    root = str(tmp_path / 'split')
    os.makedirs(f'{root}/img')
    os.makedirs(f'{root}/mask')
    rng = np.random.default_rng(0)
    for i, present in enumerate((True, False, True)):
        mask = np.zeros((32, 32, 4), np.uint8)
        if present:
            mask[4:9, 4:9, 3] = 255
        tiffio.write_tiff(f'{root}/mask/{i}.tiff', mask)
        cv2.imwrite(f'{root}/img/{i}.png', rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    tiffio.write_tiff(f'{root}/mask/orphan.tiff', np.full((32, 32, 4), 255, np.uint8))
    ours = data.OCTDataset(root, ['Vasa vasorum'], 16)
    theirs = jax_data.OCTDataset(root, ['Vasa vasorum'], 16)
    assert ours.mask_paths == theirs.mask_paths and len(ours) == 2
    with pytest.raises(ValueError):
        data.OCTDataset(root, ['Lumen'], 16)
