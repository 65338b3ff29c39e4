"""Host image work without PIL or cv2, bit-exact with what octseg calls.

- ``pil_resize_bicubic``: Pillow's default ``Image.resize`` of an 8-bit
  image of any band count (BICUBIC, a = -0.5, support scaled on downscale;
  horizontal pass, then vertical, each through uint8 with 22-bit fixed-point
  coefficients — Pillow's Resample.c ``precompute_coeffs`` and
  ``normalize_coeffs_8bpc``).
- ``pil_resize_bicubic_16``: the same resize of a 16-bit gray (I;16)
  image, in float64 coefficients (Pillow's ``ImagingResample*_16bpc``, with
  its byte-wise clipping of sums outside 0..65535).
- ``open_image`` and ``pil_resize``: ``PIL.Image.open(path)`` of a PNG or
  JPEG file in mode L, P, RGB, RGBA, I;16 or CMYK, and its default
  ``resize``: bicubic for L, RGB, I;16 and CMYK, bicubic on premultiplied
  alpha for RGBA (Pillow's RGBa round trip), NEAREST in Pillow's
  coordinates for P.
- ``paste_solid``: ``Image.paste(solid colour image, (0, 0), L mask)``,
  Pillow's integer blend DIV255(in1 * (255 - a) + in2 * a).
- ``encode_png``: an 8-bit gray, RGB or RGBA PNG through zlib;
  ``write_png`` writes a gray or RGB one.
- ``normalize_slice``: cv2.normalize(NORM_MINMAX, CV_8U).
- ``read_png``: ``cv2.imread(path)`` (IMREAD_COLOR) of any PNG (every
  colour type and bit depth, interlaced or not; alpha dropped) or JPEG
  (data/jpeg.py, EXIF orientation applied); BGR uint8.
- ``resize_linear_u8``: ``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a
  uint8 image, with cv2's 11-bit fixed-point coefficients, its rounding in
  the vertical pass and its switch to INTER_AREA for an exact 2x downscale.
- ``resize_linear_u16``: the same of a uint16 image, in float32 as cv2's
  generic code (cv2 built with IPP, the opencv-python default, rounds about
  one value in a thousand the other way).
- ``resize_nearest_u8``: ``cv2.resize(..., interpolation=INTER_NEAREST)``.
"""

from __future__ import annotations

import binascii
import struct
import zlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from octseg_torch.data.jpeg import ROADMAP_ITEM, decode_jpeg, decode_jpeg_pil

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter with a = -0.5 (same operation order)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _float_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source index, float64 weight, valid) tables, each (out_size, ksize),
    Pillow's ``precompute_coeffs``: weights normalized to sum 1, indices
    beyond a row's support clamped in range and marked invalid."""
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
    return np.minimum(xmin[:, None] + x, in_size - 1), w, valid


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source index, int32 weight) tables, each (out_size, ksize); weights
    beyond a row's support are 0 and their indices clamped in range
    (``normalize_coeffs_8bpc``)."""
    idx, w, valid = _float_coeffs(in_size, out_size)
    fixed = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return idx, np.where(valid, k, 0)


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
    """uint8 (H, W) or (H, W, C) -> (h, w[, C]) for ``size = (w, h)`` (PIL's
    order), as ``Image.fromarray(img).resize(size)`` (each band alike). A
    pass whose size does not change is skipped."""
    out_w, out_h = int(size[0]), int(size[1])
    if out_w != img.shape[1]:
        img = _resample_axis(img, 1, out_w)
    if out_h != img.shape[0]:
        img = _resample_axis(img, 0, out_h)
    return img


def _resample_axis_16(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of Pillow's ``ImagingResample*_16bpc``: the taps summed in
    float64 in order, rounded half away from zero, then stored as two bytes
    each clipped to 0..255 on its own (a sum above 65535 keeps its low byte
    under a high byte of 255; one below 0 reads 0)."""
    idx, w, valid = _float_coeffs(img.shape[axis], out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.zeros(shape, np.float64)
    for j in range(w.shape[1]):
        taps = np.take(img, idx[:, j], axis=axis).astype(np.float64)
        acc = acc + np.where(valid[:, j].reshape(shape), taps * w[:, j].reshape(shape), 0.0)
    v = np.trunc(np.where(acc >= 0, acc + 0.5, acc - 0.5)).astype(np.int64)
    low = np.clip(np.fmod(v, 256), 0, 255)
    return (np.clip(v >> 8, 0, 255) << 8 | low).astype(np.uint16)


def pil_resize_bicubic_16(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """uint16 (H, W) -> (h, w) for ``size = (w, h)``, as ``resize(size)`` of
    a PIL ``I;16`` image."""
    out_w, out_h = int(size[0]), int(size[1])
    if out_w != img.shape[1]:
        img = _resample_axis_16(img, 1, out_w)
    if out_h != img.shape[0]:
        img = _resample_axis_16(img, 0, out_h)
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


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit PNG of uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA
    (filter type 0; zlib ``level`` 6 as Pillow's default, 1 as cv2's)."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] not in (3, 4)):
        raise ValueError(f'encode_png takes uint8 (H, W), (H, W, 3) or (H, W, 4), got '
                         f'{arr.dtype} {arr.shape}')
    h, w = arr.shape[:2]
    color_type = 0 if arr.ndim == 2 else (2 if arr.shape[2] == 3 else 6)
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(raw, level)) + _png_chunk(b'IEND', b''))


def write_png(path: str, arr: np.ndarray, level: int = 6) -> None:
    """Write uint8 (H, W) gray or (H, W, 3) RGB as a PNG (``encode_png``)."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f'write_png takes uint8 (H, W) or (H, W, 3), got '
                         f'{arr.dtype} {arr.shape}')
    data = encode_png(arr, level)
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
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_JPEG_SOI = b'\xff\xd8\xff'


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
    if not ftype.any():   # every row unfiltered (what encode_png writes)
        return data
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


def _unpack_samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """(h, n) integer samples of unfiltered rows (h, row bytes), big-endian
    as PNG stores them, for a bit depth of 1, 2, 4, 8 or 16."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        return rows[:, :2 * n].view('>u2')
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    bits = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return bits.reshape(rows.shape[0], -1)[:, :n]


def _decode_png(buf: bytes, path: str) -> Tuple[np.ndarray, int, int, bytes]:
    """(samples (H, W, samples per pixel) uint8 or uint16, colour type, bit
    depth, PLTE bytes) of a PNG file; 1/2/4-bit samples unscaled."""
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
    pos, idat, ihdr, plte = 8, [], None, b''
    while pos + 8 <= len(buf):
        (length,) = struct.unpack_from('>I', buf, pos)
        tag = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif tag == b'PLTE':
            plte = body
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'IEND':
            break
    if ihdr is None:
        raise ValueError(f'{path}: PNG without IHDR')
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if depth not in _PNG_DEPTHS.get(color, ()) or interlace > 1:
        raise ValueError(f'{path}: bad PNG header (bit depth {depth}, colour type '
                         f'{color}, interlace {interlace})')
    if color == 3 and not plte:
        raise ValueError(f'{path}: palette PNG without PLTE')
    spp = _PNG_CHANNELS[color]
    bpp = max(1, spp * depth // 8)   # the filters' byte distance
    stream = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    samples = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    used = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = len(range(x0, w, dx)), len(range(y0, h, dy))
        if pw == 0 or ph == 0:
            continue
        row_bytes = -(-pw * spp * depth // 8)
        size = ph * (1 + row_bytes)
        if used + size > stream.size:
            raise ValueError(f'{path}: truncated PNG image data')
        rows = stream[used:used + size].reshape(ph, 1 + row_bytes)
        used += size
        if rows[:, 0].max(initial=0) > 4:
            raise ValueError(f'{path}: bad PNG filter type')
        px = _unfilter(rows[:, 0], rows[:, 1:].reshape(ph, row_bytes // bpp, bpp))
        samples[y0::dy, x0::dx] = _unpack_samples(px.reshape(ph, row_bytes), pw * spp,
                                                  depth).reshape(ph, pw, spp)
    return samples, color, depth, plte


def _palette_table(plte: bytes) -> np.ndarray:
    """(256, 3) uint8 RGB: the PLTE entries, black past its end."""
    table = np.zeros((256, 3), np.uint8)
    pal = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
    table[:len(pal)] = pal
    return table


def _to_8bit(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples as 8 bits: 16-bit keeps its high byte, 1/2/4-bit (gray) is
    scaled to 0..255 (what libpng and Pillow both do)."""
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def read_png(path: str) -> np.ndarray:
    """``cv2.imread(path)``: (H, W, 3) BGR uint8, as libpng and libjpeg
    expand for IMREAD_COLOR. For a PNG, every colour type and bit depth PNG
    allows, interlaced (Adam7) or not: 16-bit samples keep their high byte,
    1/2/4-bit gray is scaled to 0..255, a palette is looked up (indices past
    its end read black, tRNS is ignored), gray is replicated to three
    channels and alpha is dropped. A JPEG file (the name is kept for its
    callers) is decoded by data/jpeg.py, gray replicated and its EXIF
    orientation applied."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:3] == _JPEG_SOI:
        img = decode_jpeg(buf, orient=True)
        if img.ndim == 2:
            return np.ascontiguousarray(np.repeat(img[..., None], 3, axis=-1))
        return np.ascontiguousarray(img[..., ::-1])
    samples, color, depth, plte = _decode_png(buf, path)
    if color == 3:
        return np.ascontiguousarray(_palette_table(plte)[samples[..., 0], ::-1])
    px = _to_8bit(samples, depth)
    if color in (0, 4):
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=-1))
    return np.ascontiguousarray(px[..., 2::-1])


# ------------------------ PIL.Image.open and resize -------------------------

class PilImage(NamedTuple):
    """What ``PIL.Image.open`` holds for the modes the port reads: ``mode``
    'L', 'P', 'RGB', 'RGBA', 'I;16' or 'CMYK'; ``pixels`` as ``np.array(img)``
    gives them (uint8 (H, W) for L and P, whose values are palette indices;
    uint16 (H, W) for I;16; uint8 (H, W, 3) or (H, W, 4) otherwise);
    ``palette`` (256, 3) uint8 for P."""
    mode: str
    pixels: np.ndarray
    palette: Optional[np.ndarray] = None

    @property
    def size(self) -> Tuple[int, int]:
        """(width, height), PIL's order."""
        return self.pixels.shape[1], self.pixels.shape[0]

    def to_rgb(self) -> np.ndarray:
        """``img.convert('RGB')`` as (H, W, 3) uint8: a palette looked up
        (transparency ignored), gray replicated (16-bit gray clipped at 255),
        alpha dropped, CMYK as Pillow's cmyk2rgb: each of C, M, Y becomes
        nk - nk * x / 255 (Pillow's rounded MULDIV255), nk = 255 - K."""
        if self.mode == 'P':
            return self.palette[self.pixels]
        if self.mode in ('L', 'I;16'):
            gray = np.minimum(self.pixels, 255).astype(np.uint8)
            return np.repeat(gray[..., None], 3, axis=-1)
        if self.mode == 'CMYK':
            x = self.pixels.astype(np.int32)
            nk = 255 - x[..., 3:]
            t = x[..., :3] * nk + 128
            return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(self.pixels[..., :3])


def _unsupported_mode(path: str, mode: str) -> NotImplementedError:
    return NotImplementedError(
        f'{path}: PIL opens this file in mode {mode}, which octseg rejects too: its '
        f'cv2.cvtColor refuses the array ({ROADMAP_ITEM})')


def open_image(path: str) -> PilImage:
    """``PIL.Image.open(path)`` of a PNG or JPEG file (no EXIF orientation,
    as PIL). 1-bit and 8-bit gray-alpha PNGs, which PIL opens and octseg's
    preprocessing rejects, raise NotImplementedError."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:3] == _JPEG_SOI:
        return PilImage(*decode_jpeg_pil(buf))
    samples, color, depth, plte = _decode_png(buf, path)
    if color == 3:
        return PilImage('P', np.ascontiguousarray(samples[..., 0]), _palette_table(plte))
    if color == 0:
        if depth == 1:
            raise _unsupported_mode(path, '1')
        if depth == 16:
            return PilImage('I;16', np.ascontiguousarray(samples[..., 0]).astype(np.uint16))
        return PilImage('L', np.ascontiguousarray(_to_8bit(samples, depth)[..., 0]))
    if color == 4:
        if depth == 8:
            raise _unsupported_mode(path, 'LA')
        g = _to_8bit(samples, 16)   # Pillow reads 16-bit gray-alpha as RGBA
        return PilImage('RGBA', np.ascontiguousarray(g[..., [0, 0, 0, 1]]))
    return PilImage('RGB' if color == 2 else 'RGBA',
                    np.ascontiguousarray(_to_8bit(samples, depth)))


def _pil_nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's NEAREST source index per output pixel: the centre position,
    accumulated by repeated float64 addition of the scale as its affine
    scaler does, truncated."""
    scale = in_size / out_size
    pos = np.add.accumulate(np.concatenate([[scale * 0.5], np.full(out_size - 1, scale)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int64) * b + 128
    return ((t >> 8) + t) >> 8


def pil_resize(img: PilImage, size: Sequence[int]) -> PilImage:
    """``img.resize(size)`` with Pillow's default filter for the mode,
    ``size = (w, h)``."""
    out_w, out_h = int(size[0]), int(size[1])
    if (out_w, out_h) == img.size:
        return PilImage(img.mode, img.pixels.copy(), img.palette)
    if img.mode == 'P':
        rows = _pil_nearest_indices(img.pixels.shape[0], out_h)
        cols = _pil_nearest_indices(img.pixels.shape[1], out_w)
        return PilImage('P', np.ascontiguousarray(img.pixels[rows][:, cols]), img.palette)
    if img.mode == 'RGBA':
        # RGBA -> RGBa (premultiplied, rounded) -> resize -> RGBA (truncated)
        px = img.pixels.astype(np.int64)
        alpha = px[..., 3:]
        pre = np.concatenate([_muldiv255(px[..., :3], alpha), alpha], -1).astype(np.uint8)
        res = pil_resize_bicubic(pre, (out_w, out_h)).astype(np.int64)
        a = res[..., 3:]
        un = np.where((a == 0) | (a == 255), res[..., :3],
                      np.minimum(255 * res[..., :3] // np.maximum(a, 1), 255))
        return PilImage('RGBA', np.concatenate([un, a], -1).astype(np.uint8))
    if img.mode == 'I;16':
        return PilImage('I;16', pil_resize_bicubic_16(img.pixels, (out_w, out_h)))
    return PilImage(img.mode, pil_resize_bicubic(img.pixels, (out_w, out_h)))


# ------------------------- cv2 resize of uint8 images -----------------------

_RESIZE_COEF_SCALE = 2048   # cv2 INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _linear_positions(in_size: int, out_size: int, clamp: bool):
    """cv2's INTER_LINEAR positions for one axis: (first index, second index,
    float32 fraction of the second).

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
    return s, s1, f


def _linear_taps(in_size: int, out_size: int, clamp: bool):
    """cv2's INTER_LINEAR table for one axis: (first index, second index,
    first weight, second weight), weights as int16 fixed point."""
    s, s1, f = _linear_positions(in_size, out_size, clamp)
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


def resize_linear_u16(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR) of a uint16 (H, W) or
    (H, W, C) image, ``size = (w, h)``: float32 weights 1 - f and f, the
    horizontal pass then the vertical one in float32, rounded half to even
    and saturated; an exact 2x downscale on both axes is INTER_AREA's
    rounded mean of each 2x2 block, as for uint8."""
    if img.dtype != np.uint16 or img.ndim not in (2, 3):
        raise ValueError(f'resize_linear_u16 takes uint16 (H, W[, C]), got {img.dtype} '
                         f'{img.shape}')
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    if w == 2 * out_w and h == 2 * out_h:
        x = img.astype(np.int64)
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2)
                >> 2).astype(np.uint16)
    extra = (1,) * (img.ndim - 2)
    one = np.float32(1)
    xs0, xs1, fx = _linear_positions(w, out_w, clamp=True)
    ys0, ys1, fy = _linear_positions(h, out_h, clamp=False)
    x = img.astype(np.float32)
    rows = x[:, xs0] * (one - fx).reshape(1, -1, *extra) + x[:, xs1] * fx.reshape(1, -1, *extra)
    fy = fy.reshape(-1, 1, *extra)
    v = rows[ys0] * (one - fy) + rows[ys1] * fy
    return np.clip(np.rint(v), 0, 65535).astype(np.uint16)


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """cv2 resizeNN source index per output index, bit-exact: the scale is
    the double-rounded reciprocal 1.0 / (out / in), in float64."""
    scale = 1.0 / (out_size / in_size)
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest_u8(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``, ``size =
    (w, h)``; a (H, W, 1) input comes back (h, w), as from cv2."""
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    rows = nearest_indices(int(size[1]), img.shape[0])
    cols = nearest_indices(int(size[0]), img.shape[1])
    return np.ascontiguousarray(img[rows][:, cols])
