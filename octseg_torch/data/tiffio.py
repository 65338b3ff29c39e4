"""Minimal TIFF codec for N-channel uint8 segmentation masks.

A copy of octseg/data/tiffio.py. LZW goes through the port's copy of
octseg's C++ codec (``csrc/lzw.cc``, built with g++ at first use), as
octseg's does; the Python codec below is its plain version, which the
tests hold it to, and takes over where octseg's does: a decode without a
known size, and a stream the C++ codec rejects.

- read:  uint8, PlanarConfig=contig, any SamplesPerPixel, strips,
         compression None(1) / LZW(5) / Deflate(8, zip), predictor 1/2,
         little- and big-endian files.
- write: uint8, contiguous, one strip, compression None / LZW / Deflate.

The LZW encoder keys its table by (prefix code, next byte) integers rather
than byte strings; it emits the same codes, so its files are byte-identical
to octseg's.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from octseg_torch.ops.kernels import _build

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_EXTRA_SAMPLES = 338
_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: 'B', 3: 'H', 4: 'I', 6: 'b', 8: 'h', 9: 'i', 11: 'f', 12: 'd'}


def _native_lzw() -> ctypes.CDLL:
    lib = _build.load_host('lzw')
    if not getattr(lib, '_configured', False):
        for fn in (lib.octseg_lzw_encode, lib.octseg_lzw_decode):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib._configured = True
    return lib


def lzw_encode(data: bytes) -> bytes:
    """TIFF-variant LZW encode in C++ (``csrc/lzw.cc``)."""
    cap = len(data) + len(data) // 2 + 4096
    buf = ctypes.create_string_buffer(cap)
    n = _native_lzw().octseg_lzw_encode(data, len(data), buf, cap)
    return buf.raw[:n] if n >= 0 else _lzw_encode(data)


def lzw_decode(data: bytes, expected_size: Optional[int] = None) -> bytes:
    """TIFF-variant LZW decode in C++ (``csrc/lzw.cc``) into at most
    ``expected_size`` bytes; without a size, or where the stream holds more
    or is malformed, the Python decoder's result, as in octseg."""
    if expected_size is not None:
        buf = ctypes.create_string_buffer(expected_size)
        n = _native_lzw().octseg_lzw_decode(data, len(data), buf, expected_size)
        if n >= 0:
            return buf.raw[:n]
    return _lzw_decode(data)


def _lzw_decode(data: bytes) -> bytes:
    """Decode TIFF-variant LZW (MSB-first bit packing, early code change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b'', b'']
    bitpos = 0
    nbits = 9
    prev: bytes = b''
    data_len_bits = len(data) * 8
    # Fast bit reader over an int is simpler but slow for MBs; use byte math.
    while bitpos + nbits <= data_len_bits:
        byte_idx = bitpos >> 3
        # read 4 bytes window (enough for up to 12-bit codes at any alignment)
        window = int.from_bytes(data[byte_idx:byte_idx + 4].ljust(4, b'\0'), 'big')
        shift = 32 - (bitpos & 7) - nbits
        code = (window >> shift) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == EOI:
            break
        if code == CLEAR:
            table = table[:258]
            nbits = 9
            prev = b''
            continue
        if prev == b'':
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF LZW "early change": widen one entry before the table fills
        # (verified against libtiff/tifffile-encoded reference masks).
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    """Encode TIFF-variant LZW (MSB-first, early code change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code: int, nbits: int) -> None:
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << nbits) | code
        bitcnt += nbits
        while bitcnt >= 8:
            bitcnt -= 8
            out.append((bitbuf >> bitcnt) & 0xFF)
        bitbuf &= (1 << bitcnt) - 1

    # (prefix code << 8 | byte) -> code; single bytes are their own codes
    table: Dict[int, int] = {}
    next_code = 258
    nbits = 9
    emit(CLEAR, nbits)
    w = -1
    for c in data:
        if w < 0:
            w = c
            continue
        code = table.get((w << 8) | c)
        if code is not None:
            w = code
            continue
        emit(w, nbits)
        table[(w << 8) | c] = next_code
        next_code += 1
        # the decoder widens one entry early, so the encoder's first wide
        # code is (1 << nbits) - 1
        if nbits < 12 and next_code == (1 << nbits):
            nbits += 1
        elif nbits == 12 and next_code == (1 << 12) - 2:
            emit(CLEAR, nbits)
            table = {}
            next_code = 258
            nbits = 9
        w = c
    if w >= 0:
        emit(w, nbits)
    emit(EOI, nbits)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _read_ifd(buf: bytes, offset: int, bo: str) -> Dict[int, Tuple[int, list]]:
    (count,) = struct.unpack_from(bo + 'H', buf, offset)
    tags: Dict[int, Tuple[int, list]] = {}
    for i in range(count):
        base = offset + 2 + i * 12
        tag, typ, n = struct.unpack_from(bo + 'HHI', buf, base)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            raw = buf[base + 8:base + 8 + size]
        else:
            (ptr,) = struct.unpack_from(bo + 'I', buf, base + 8)
            raw = buf[ptr:ptr + size]
        if typ in _TYPE_FMT:
            vals = list(struct.unpack(bo + str(n) + _TYPE_FMT[typ], raw))
        elif typ == 5:  # RATIONAL
            ints = struct.unpack(bo + str(2 * n) + 'I', raw)
            vals = [ints[2 * k] / max(ints[2 * k + 1], 1) for k in range(n)]
        else:
            vals = [raw]
        tags[tag] = (typ, vals)
    return tags


def read_tiff(path: str) -> np.ndarray:
    """Read the first IFD of a TIFF into (H, W) or (H, W, C) uint8 array."""
    with open(path, 'rb') as f:
        buf = f.read()
    magic = buf[:2]
    if magic == b'II':
        bo = '<'
    elif magic == b'MM':
        bo = '>'
    else:
        raise ValueError(f'{path}: not a TIFF file')
    (forty_two, ifd_off) = struct.unpack_from(bo + 'HI', buf, 2)
    if forty_two != 42:
        raise ValueError(f'{path}: bad TIFF magic number {forty_two}')
    tags = _read_ifd(buf, ifd_off, bo)

    def tagval(tag: int, default=None):
        if tag in tags:
            return tags[tag][1]
        return default

    width = tagval(_IMAGE_WIDTH)[0]
    height = tagval(_IMAGE_LENGTH)[0]
    spp = tagval(_SAMPLES_PER_PIXEL, [1])[0]
    bps = tagval(_BITS_PER_SAMPLE, [8])
    compression = tagval(_COMPRESSION, [1])[0]
    predictor = tagval(_PREDICTOR, [1])[0]
    planar = tagval(_PLANAR_CONFIG, [1])[0]
    if any(b != 8 for b in bps):
        raise NotImplementedError(f'{path}: only 8-bit samples supported, got {bps}')
    if planar != 1:
        raise NotImplementedError(f'{path}: only contiguous planar config supported')

    offsets = tagval(_STRIP_OFFSETS)
    counts = tagval(_STRIP_BYTE_COUNTS)
    rows_per_strip = tagval(_ROWS_PER_STRIP, [height])[0]

    raw = bytearray()
    total_expected = height * width * spp
    for off, cnt in zip(offsets, counts):
        chunk = bytes(buf[off:off + cnt])
        if compression == 1:
            raw += chunk
        elif compression == 5:
            strip_cap = min(rows_per_strip * width * spp, total_expected - len(raw))
            raw += lzw_decode(chunk, strip_cap)[:strip_cap]
        elif compression in (8, 32946):
            raw += zlib.decompress(chunk)
        else:
            raise NotImplementedError(f'{path}: compression {compression} not supported')

    arr = np.frombuffer(bytes(raw), dtype=np.uint8)
    expected = height * width * spp
    arr = arr[:expected].reshape(height, width, spp) if spp > 1 else arr[:expected].reshape(
        height, width
    )
    if predictor == 2:  # horizontal differencing
        arr = np.cumsum(arr.astype(np.uint32), axis=1).astype(np.uint8)
    return np.ascontiguousarray(arr)


def write_tiff(path: str, arr: np.ndarray, compression: str = 'lzw') -> None:
    """Write a (H, W) or (H, W, C) uint8 array as a single-IFD TIFF."""
    if arr.dtype != np.uint8:
        raise ValueError(f'write_tiff expects uint8, got {arr.dtype}')
    if arr.ndim == 2:
        arr = arr[:, :, None]
    height, width, spp = arr.shape
    data = np.ascontiguousarray(arr).tobytes()

    if compression == 'lzw':
        comp_id, payload = 5, lzw_encode(data)
    elif compression in ('zip', 'deflate'):
        comp_id, payload = 8, zlib.compress(data, 6)
    elif compression in (None, 'none', 'raw'):
        comp_id, payload = 1, data
    else:
        raise ValueError(f'Unknown compression {compression!r}')

    # photometric: 1 = BlackIsZero for 1/2ch, 2 = RGB for >=3ch
    photometric = 2 if spp >= 3 else 1
    extra = max(0, spp - (3 if spp >= 3 else 1))

    tags = [
        (_IMAGE_WIDTH, 4, 1, [width]),
        (_IMAGE_LENGTH, 4, 1, [height]),
        (_BITS_PER_SAMPLE, 3, spp, [8] * spp),
        (_COMPRESSION, 3, 1, [comp_id]),
        (_PHOTOMETRIC, 3, 1, [photometric]),
        (_STRIP_OFFSETS, 4, 1, [0]),  # patched below
        (_SAMPLES_PER_PIXEL, 3, 1, [spp]),
        (_ROWS_PER_STRIP, 4, 1, [height]),
        (_STRIP_BYTE_COUNTS, 4, 1, [len(payload)]),
        (_PLANAR_CONFIG, 3, 1, [1]),
        (_SAMPLE_FORMAT, 3, spp, [1] * spp),
    ]
    if extra:
        # mark extra channels as unassociated alpha so standard readers accept them
        tags.append((_EXTRA_SAMPLES, 3, extra, [2] * extra))
    tags.sort(key=lambda t: t[0])

    header = struct.pack('<2sHI', b'II', 42, 8)
    ifd_entry_count = len(tags)
    ifd_size = 2 + ifd_entry_count * 12 + 4
    # layout: header(8) | IFD | overflow values | pixel payload
    overflow_pos = 8 + ifd_size
    overflow = bytearray()
    entries = b''
    for tag, typ, n, vals in tags:
        size = _TYPE_SIZES[typ] * n
        fmt = _TYPE_FMT[typ]
        packed = struct.pack('<' + str(n) + fmt, *vals)
        if size <= 4:
            value_field = packed.ljust(4, b'\0')
        else:
            value_field = struct.pack('<I', overflow_pos + len(overflow))
            overflow += packed
        entries += struct.pack('<HHI', tag, typ, n) + value_field

    data_pos = overflow_pos + len(overflow)
    # patch the strip offset value
    entries = bytearray(entries)
    for i in range(ifd_entry_count):
        base = i * 12
        (tag,) = struct.unpack_from('<H', entries, base)
        if tag == _STRIP_OFFSETS:
            struct.pack_into('<I', entries, base + 8, data_pos)

    with open(path, 'wb') as f:
        f.write(header)
        f.write(struct.pack('<H', ifd_entry_count))
        f.write(bytes(entries))
        f.write(struct.pack('<I', 0))  # next IFD offset
        f.write(bytes(overflow))
        f.write(payload)
