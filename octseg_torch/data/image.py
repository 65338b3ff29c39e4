"""Host image work without PIL or cv2, bit-exact with what octseg calls.

- ``pil_resize_bicubic``: Pillow's default ``Image.resize`` of an RGB image
  (BICUBIC, a = -0.5, support scaled on downscale; horizontal pass, then
  vertical, each through uint8 with 22-bit fixed-point coefficients —
  Pillow's Resample.c ``precompute_coeffs`` and ``normalize_coeffs_8bpc``).
- ``paste_solid``: ``Image.paste(solid colour image, (0, 0), L mask)``,
  Pillow's integer blend DIV255(in1 * (255 - a) + in2 * a).
- ``write_png``: an 8-bit gray or RGB PNG through zlib.
- ``normalize_slice``: cv2.normalize(NORM_MINMAX, CV_8U).
"""

from __future__ import annotations

import binascii
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

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
