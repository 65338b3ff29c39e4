"""Host image work without PIL or cv2, bit-exact with what octseg calls.

- ``pil_resize_bicubic``: Pillow's default ``Image.resize`` of an RGB image
  (BICUBIC, a = -0.5, support scaled on downscale; horizontal pass, then
  vertical, each through uint8 with 22-bit fixed-point coefficients —
  Pillow's Resample.c ``precompute_coeffs`` and ``normalize_coeffs_8bpc``).
- ``paste_solid``: ``Image.paste(solid colour image, (0, 0), L mask)``,
  Pillow's integer blend DIV255(in1 * (255 - a) + in2 * a).
- ``write_png``: an 8-bit gray or RGB PNG through zlib.
- ``normalize_slice``: cv2.normalize(NORM_MINMAX, CV_8U).
- ``read_png``: ``cv2.imread(path)`` (IMREAD_COLOR) of an 8-bit,
  non-interlaced gray, gray+alpha, RGB or RGBA PNG: BGR uint8, alpha dropped.
- ``resize_linear_u8``: ``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a
  uint8 image, with cv2's 11-bit fixed-point coefficients, its rounding in
  the vertical pass and its switch to INTER_AREA for an exact 2x downscale.
- ``resize_nearest_u8``: ``cv2.resize(..., interpolation=INTER_NEAREST)``.
"""

from __future__ import annotations

import binascii
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

from octseg_torch.ops.resize import nearest_indices

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter with a = -0.5 (same operation order)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source index, int32 weight) tables, each (out_size, ksize); weights
    beyond a row's support are 0 and their indices clamped in range."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C casts truncate toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)[None, :]
    valid = x < xmax[:, None]
    w = np.where(valid, _bicubic((x + xmin[:, None] - center[:, None] + 0.5)
                                 * (1.0 / filterscale)), 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    k = np.where(valid, k, 0)
    idx = np.minimum(xmin[:, None] + x, in_size - 1)
    return idx, k


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    idx, k = _coeffs(img.shape[axis], out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    # int32 as in Pillow: |sum| <= 255 * 2**22 * sum|k| stays below 2**31
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        acc = acc + np.take(img, idx[:, j], axis=axis).astype(np.int32) \
            * k[:, j].astype(np.int32).reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize_bicubic(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """uint8 (H, W, 3) -> (h, w, 3) for ``size = (w, h)`` (PIL's order), as
    ``Image.fromarray(img).resize(size)``. A pass whose size does not change
    is skipped."""
    out_w, out_h = int(size[0]), int(size[1])
    if out_w != img.shape[1]:
        img = _resample_axis(img, 1, out_w)
    if out_h != img.shape[0]:
        img = _resample_axis(img, 0, out_h)
    return img


def _div255(v: np.ndarray) -> np.ndarray:
    v = v + 128
    return ((v >> 8) + v) >> 8


def paste_solid(img: np.ndarray, color: Sequence[int], alpha8: np.ndarray) -> np.ndarray:
    """In place on uint8 (H, W, 3) ``img``: blend the solid ``color`` with
    per-pixel uint8 alpha ``alpha8`` (H, W). Returns ``img``."""
    a = alpha8.astype(np.int32)[..., None]
    c = np.asarray(color, np.int32)
    img[...] = _div255(img.astype(np.int32) * (255 - a) + c * a)
    return img


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = binascii.crc32(tag + data) & 0xffffffff
    return struct.pack('>I', len(data)) + tag + data + struct.pack('>I', crc)


def write_png(path: str, arr: np.ndarray) -> None:
    """Write uint8 (H, W) gray or (H, W, 3) RGB as a PNG (filter type 0,
    zlib level 6 as Pillow's default)."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f'write_png takes uint8 (H, W) or (H, W, 3), got '
                         f'{arr.dtype} {arr.shape}')
    h, w = arr.shape[:2]
    color_type = 2 if arr.ndim == 3 else 0
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    data = (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(raw, 6)) + _png_chunk(b'IEND', b''))
    with open(path, 'wb') as f:
        f.write(data)


def normalize_slice(img: np.ndarray) -> np.ndarray:
    """cv2.normalize(img, None, 0, 255, NORM_MINMAX, CV_8U): scale =
    255 * (1 / (max - min)) (0 when max == min), shift = -min * scale, then
    ``convertTo``: float32 fused multiply-add, round half to even, saturate."""
    smin, smax = float(img.min()), float(img.max())
    scale = 255.0 * (1.0 / (smax - smin) if smax - smin > np.finfo(np.float64).eps else 0.0)
    shift = 0.0 - smin * scale
    a, b = np.float32(scale), np.float32(shift)
    # x * a is exact in float64 for integer pixels; one rounding to float32
    # of x * a + b is what a float32 FMA gives
    v = (img.astype(np.float64) * np.float64(a) + np.float64(b)).astype(np.float32)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


# ------------------------------- PNG reader --------------------------------

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    da = a - c
    db = b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo PNG row filtering of ``data`` (H, W, bpp) uint8, one filter type
    per row.

    Pixel (y, x) depends on (y, x-1), (y-1, x) and (y-1, x-1), so all pixels
    of one anti-diagonal y + x = d are independent. They are decoded together,
    diagonal after diagonal, in a skewed buffer that stores pixel (y, x) at
    ``out[x + y + 2, y + 1]``: each diagonal is one contiguous block, and its
    left, up and up-left neighbours are slices of the two blocks before it.
    Block 0, block 1 and row 0 of every block are the zero border the
    filters assume."""
    h, w, bpp = data.shape
    ys = np.arange(h)[:, None]
    diag = np.arange(w)[None, :] + ys
    raw = np.zeros((w + h - 1, h, bpp), np.int16)
    raw[diag, ys] = data
    out = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    # the five predictions of every row (None's stays 0), and for each row
    # the flat index of its own filter's prediction
    preds = np.zeros((5, h, bpp), np.int16)
    pick = (ftype.astype(np.int64)[:, None] * (h * bpp) + ys * bpp
            + np.arange(bpp)[None, :])
    avg_or_paeth = bool(np.isin(ftype, (3, 4)).any())
    for d in range(w + h - 1):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        c = d + 2
        left = out[c - 1, r0 + 1:r1 + 1]
        up = out[c - 1, r0:r1]
        preds[1, r0:r1] = left
        preds[2, r0:r1] = up
        if avg_or_paeth:
            np.right_shift(left + up, 1, out=preds[3, r0:r1])
            preds[4, r0:r1] = _paeth(left, up, out[c - 2, r0:r1])
        pred = preds.reshape(-1).take(pick[r0:r1])
        np.bitwise_and(raw[d, r0:r1] + pred, 255, out=out[c, r0 + 1:r1 + 1])
    return out[diag + 2, ys + 1].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """``cv2.imread(path)``: (H, W, 3) BGR uint8. Gray is replicated to three
    channels and alpha is dropped, as IMREAD_COLOR does; palette, 16-bit and
    interlaced files raise."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(buf):
        (length,) = struct.unpack_from('>I', buf, pos)
        tag = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'IEND':
            break
    if ihdr is None:
        raise ValueError(f'{path}: PNG without IHDR')
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise NotImplementedError(
            f'{path}: read_png takes 8-bit non-interlaced gray, gray+alpha, RGB or '
            f'RGBA PNGs (bit depth {depth}, colour type {color}, interlace {interlace})')
    bpp = _PNG_CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if rows.size != h * (1 + w * bpp):
        raise ValueError(f'{path}: truncated PNG image data')
    rows = rows.reshape(h, 1 + w * bpp)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f'{path}: bad PNG filter type')
    px = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
    if bpp <= 2:
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=-1))
    return np.ascontiguousarray(px[..., 2::-1])


# ------------------------- cv2 resize of uint8 images -----------------------

_RESIZE_COEF_SCALE = 2048   # cv2 INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _linear_taps(in_size: int, out_size: int, clamp: bool):
    """cv2's INTER_LINEAR table for one axis: (first index, second index,
    first weight, second weight), weights as int16 fixed point.

    The source position is float((d + 0.5) * scale - 0.5) with the
    double-rounded scale 1 / (out / in), floored in float32. Along x
    (``clamp``) a position left of 0 or right of in - 1 snaps to the edge
    pixel with weight 0 on its neighbour; along y cv2 keeps the fraction and
    clips the row indices instead."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        f[(s < 0) | (s >= in_size - 1)] = 0
        s = np.clip(s, 0, in_size - 1)
    s1 = np.clip(s + 1, 0, in_size - 1)
    s = np.clip(s, 0, in_size - 1)
    # saturate_cast<short>(float) rounds half to even, as np.rint
    w0 = np.rint((np.float32(1) - f) * np.float32(_RESIZE_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_RESIZE_COEF_SCALE)).astype(np.int64)
    return s, s1, w0, w1


def resize_linear_u8(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, size)`` for uint8 (H, W) or (H, W, C), ``size =
    (w, h)`` (cv2's order), bit-exact.

    The horizontal pass sums taps times 11-bit weights in integers; the
    vertical pass computes ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16),
    rounded by (v + 2) >> 2, as cv2's VResizeLinear for uint8 does. An exact
    2x downscale on both axes is cv2's INTER_AREA: the rounded mean of each
    2x2 block. A (H, W, 1) input comes back (h, w), as from cv2."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f'resize_linear_u8 takes uint8 (H, W[, C]), got {img.dtype} {img.shape}')
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    x = img.astype(np.int64)
    if w == 2 * out_w and h == 2 * out_h:
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    extra = (1,) * (img.ndim - 2)
    xs0, xs1, a0, a1 = _linear_taps(w, out_w, clamp=True)
    ys0, ys1, b0, b1 = _linear_taps(h, out_h, clamp=False)
    rows = (x[:, xs0] * a0.reshape(1, -1, *extra) + x[:, xs1] * a1.reshape(1, -1, *extra)) >> 4
    b0 = b0.reshape(-1, 1, *extra)
    b1 = b1.reshape(-1, 1, *extra)
    v = ((b0 * rows[ys0]) >> 16) + ((b1 * rows[ys1]) >> 16)
    return ((v + 2) >> 2).astype(np.uint8)


def resize_nearest_u8(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``, ``size =
    (w, h)``; a (H, W, 1) input comes back (h, w), as from cv2."""
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    rows = nearest_indices(int(size[1]), img.shape[0])
    cols = nearest_indices(int(size[0]), img.shape[1])
    return np.ascontiguousarray(img[rows][:, cols])
