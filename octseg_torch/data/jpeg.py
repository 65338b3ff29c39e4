"""Sequential JPEG decoding, bit-exact with libjpeg-turbo's default decode.

octseg reads JPEG files and JPEG-compressed DICOM frames through
``cv2.imdecode``/``cv2.imread`` and ``PIL.Image.open``, both libjpeg-turbo
with its defaults. This module reproduces that decode without either:

- baseline (SOF0) and extended (SOF1) sequential Huffman streams at 8-bit
  precision, 1 or 3 components, any integral sampling factors, restart
  intervals (DRI), several DHT and DQT segments, several scans;
- dequantization and the islow IDCT of ``jidctint.c`` (13-bit constants,
  2 pass-1 bits) with its 1024-entry range-limit table;
- the upsampling of ``jdsample.c`` with ``do_fancy_upsampling``: triangle
  filters for h2v1 and h2v2 (chroma at least 3 samples wide) and for h1v2,
  each with its alternating rounding biases and the last real row and
  column repeated at the edges; replication for every other factor;
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c``;
- libjpeg's colour-space guess for 3 components: a JFIF marker means YCbCr,
  an Adobe marker with transform 0 RGB (1 or other: YCbCr), component ids
  'R', 'G', 'B' RGB, anything else YCbCr.

Progressive, lossless, hierarchical and arithmetic-coded streams, 12-bit
samples and 2 or 4 components raise NotImplementedError (ROADMAP.md, "JPEG
forms and image modes octseg reads through cv2 and PIL").

The entropy stage (Huffman codes and restart segments to int16 coefficient
blocks) has two implementations: ``csrc/jpeg_entropy.cc``, host C++ built
with g++ at first use and loaded with ctypes, which ``decode_jpeg`` uses by
default, and ``_decode_scan_python``, its plain version, which the tests hold
it to. Everything after that stage is numpy shared by both.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

ROADMAP_ITEM = 'ROADMAP.md, "JPEG forms and image modes octseg reads through cv2 and PIL"'

# position in the zigzag scan -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED_SOF = {
    0xC2: 'progressive (SOF2)', 0xC3: 'lossless (SOF3)', 0xC5: 'differential (SOF5)',
    0xC6: 'differential progressive (SOF6)', 0xC7: 'differential lossless (SOF7)',
    0xC9: 'arithmetic-coded (SOF9)', 0xCA: 'arithmetic-coded progressive (SOF10)',
    0xCB: 'arithmetic-coded lossless (SOF11)', 0xCD: 'differential arithmetic (SOF13)',
    0xCE: 'differential arithmetic progressive (SOF14)',
    0xCF: 'differential arithmetic lossless (SOF15)',
}


class Component(NamedTuple):
    ident: int
    h: int
    v: int
    tq: int


class _Frame:
    """The parsed stream: frame header, tables and markers."""

    def __init__(self):
        self.width = self.height = 0
        self.components: List[Component] = []
        self.qt: Dict[int, np.ndarray] = {}       # slot -> 64 values, natural order
        self.huff_bits = np.zeros((8, 17), np.uint8)   # slots 0-3 DC, 4-7 AC
        self.huff_vals = np.zeros((8, 256), np.uint8)
        self.restart_interval = 0
        self.jfif = False
        self.adobe_transform: Optional[int] = None
        self.orientation = 1
        self.coef: List[np.ndarray] = []          # per component (bh, bw, 64) int16
        self.latched_qt: Dict[int, np.ndarray] = {}

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)

    def comp_size(self, c: Component) -> Tuple[int, int]:
        """(downsampled height, width) of a component, as libjpeg rounds."""
        return (-(-self.height * c.v // self.vmax), -(-self.width * c.h // self.hmax))


# ------------------------------- entropy stage ------------------------------

def _huffman_lut(bits: np.ndarray, vals: np.ndarray) -> List[int]:
    """16-bit lookahead table, as the C++ builds it: (length << 8) | symbol."""
    lut = [0] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(int(bits[length])):
            if k >= 256 or code >= (1 << length):
                raise ValueError('bad Huffman table')
            entry = (length << 8) | int(vals[k])
            first = code << (16 - length)
            lut[first:first + (1 << (16 - length))] = [entry] * (1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return lut


def _segment_bytes(seg: bytes) -> bytes:
    """A restart segment's bit stream: cut at the first FF not followed by
    00 (a marker or fill; zero bits follow), FF 00 read as FF, zero-padded."""
    cut = 0
    while True:
        i = seg.find(b'\xff', cut)
        if i < 0 or i + 1 >= len(seg) or seg[i + 1] != 0:
            if i >= 0:
                seg = seg[:i]
            break
        cut = i + 2
    return seg.replace(b'\xff\x00', b'\xff') + bytes(8)


def _decode_scan_python(data: bytes, segments: List[Tuple[int, int]], restart: int,
                        comps, planes: List[np.ndarray], frame: _Frame,
                        mcus_x: int, mcus_y: int) -> None:
    """The plain version of ``csrc/jpeg_entropy.cc``: decode one scan's
    Huffman-coded blocks into ``planes`` (one (bh, bw, 64) int16 array per
    scan component). ``comps``: (h, v, dc slot, ac slot) per component."""
    dc_luts = [_huffman_lut(frame.huff_bits[td], frame.huff_vals[td]) for _h, _v, td, _ta in comps]
    ac_luts = [_huffman_lut(frame.huff_bits[4 + ta], frame.huff_vals[4 + ta])
               for _h, _v, _td, ta in comps]
    zigzag = ZIGZAG.tolist()
    total = mcus_x * mcus_y
    per_segment = restart if restart > 0 else total
    flat = [p.reshape(-1, 64) for p in planes]
    mcu = 0
    for start, end in segments:
        if mcu >= total:
            break
        d = _segment_bytes(data[start:end])
        pos = 0                     # bit position

        def bits(n: int) -> int:
            nonlocal d, pos
            i = pos >> 3
            if i + 3 > len(d):
                d += bytes(8)       # zero bits past the end
            v = ((d[i] << 16 | d[i + 1] << 8 | d[i + 2]) << (pos & 7)) >> (24 - n) & ((1 << n) - 1)
            pos += n
            return v

        def huffman(lut: List[int]) -> int:
            nonlocal d, pos
            i = pos >> 3
            if i + 3 > len(d):
                d += bytes(8)
            e = lut[((d[i] << 16 | d[i + 1] << 8 | d[i + 2]) << (pos & 7)) >> 8 & 0xFFFF]
            if e == 0:
                raise ValueError('corrupt JPEG data: bad Huffman code')
            pos += e >> 8
            return e & 0xFF

        def extend(s: int) -> int:
            if s == 0:
                return 0
            v = bits(s)
            return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

        pred = [0] * len(comps)
        for _ in range(min(per_segment, total - mcu)):
            my, mx = divmod(mcu, mcus_x)
            for c, (h, v, _td, _ta) in enumerate(comps):
                bw = planes[c].shape[1]
                for by in range(v):
                    for bx in range(h):
                        block = flat[c][(my * v + by) * bw + mx * h + bx]
                        block[:] = 0
                        t = huffman(dc_luts[c])
                        if t > 16:
                            raise ValueError('corrupt JPEG data: bad DC category')
                        pred[c] += extend(t)
                        block[0] = pred[c]
                        k = 1
                        while k < 64:
                            rs = huffman(ac_luts[c])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            val = extend(s)
                            if k > 63:
                                break
                            block[zigzag[k]] = val
                            k += 1
            mcu += 1


def _entropy_library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load_host('jpeg_entropy')
    fn = lib.octseg_jpeg_decode_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


def _decode_scan_native(data: bytes, segments: List[Tuple[int, int]], restart: int,
                        comps, planes: List[np.ndarray], frame: _Frame,
                        mcus_x: int, mcus_y: int) -> None:
    """``_decode_scan_python``'s contract, in ``csrc/jpeg_entropy.cc``."""
    fn = _entropy_library().octseg_jpeg_decode_scan
    buf = np.frombuffer(data, np.uint8)
    starts = np.array([s for s, _e in segments], np.int64)
    ends = np.array([e for _s, e in segments], np.int64)
    cols = [np.array(col, np.int32) for col in zip(*comps)]   # h, v, dc slot, ac slot
    blocks_w = np.array([p.shape[1] for p in planes], np.int32)
    ptrs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
    bits = np.ascontiguousarray(frame.huff_bits)
    vals = np.ascontiguousarray(frame.huff_vals)
    rc = fn(buf.ctypes.data, starts.ctypes.data, ends.ctypes.data, len(segments), restart,
            len(planes), cols[0].ctypes.data, cols[1].ctypes.data, blocks_w.ctypes.data,
            ctypes.cast(ptrs, ctypes.c_void_p), cols[2].ctypes.data, cols[3].ctypes.data,
            bits.ctypes.data, vals.ctypes.data, mcus_x, mcus_y)
    if rc != 0:
        raise ValueError({-1: 'corrupt JPEG data: bad Huffman code',
                          -2: 'bad Huffman table'}.get(rc, f'entropy decoder error {rc}'))


# ------------------------------ marker parsing ------------------------------

def _scan_end(buf: bytes, start: int) -> Tuple[int, List[Tuple[int, int]]]:
    """(offset of the marker that ends the scan's entropy-coded data, the
    restart segments' (start, end) offsets)."""
    arr = np.frombuffer(buf, np.uint8)
    ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    end = int(ends[0]) if ends.size else len(buf)
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    segments, s = [], start
    for r in rst.tolist():
        segments.append((s, r))
        s = r + 2
    segments.append((s, end))
    return end, segments


def _exif_orientation(seg: bytes) -> int:
    """The EXIF orientation (tag 0x0112 of IFD0) of an APP1 segment; 1 if
    absent."""
    if len(seg) < 14 or seg[:6] != b'Exif\x00\x00':
        return 1
    tiff = seg[6:]
    endian = {b'II': '<', b'MM': '>'}.get(bytes(tiff[:2]))
    if endian is None:
        return 1
    (ifd,) = struct.unpack_from(endian + 'I', tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack_from(endian + 'H', tiff, ifd)
    for i in range(count):
        off = ifd + 2 + 12 * i
        if off + 12 > len(tiff):
            break
        tag, typ = struct.unpack_from(endian + 'HH', tiff, off)
        if tag == 0x0112 and typ == 3:
            return struct.unpack_from(endian + 'H', tiff, off + 8)[0]
    return 1


def _decode_scan(frame: _Frame, buf: bytes, seg: bytes, pos: int, native: bool) -> int:
    """Parse one SOS segment and decode its scan; returns the offset of the
    marker after the scan."""
    if not frame.components:
        raise ValueError('JPEG scan before its frame header')
    ns = seg[0]
    comps, planes, idxs = [], [], []
    for i in range(ns):
        cs, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        idx = next((k for k, c in enumerate(frame.components) if c.ident == cs), None)
        if idx is None:
            raise ValueError(f'JPEG scan names component {cs}, which the frame lacks')
        c = frame.components[idx]
        if c.tq not in frame.qt:
            raise ValueError(f'JPEG component {cs} uses quantization table {c.tq}, '
                             f'which is not defined')
        # libjpeg latches a component's table at its first scan
        frame.latched_qt.setdefault(idx, frame.qt[c.tq].copy())
        # a scan of one component is not interleaved: its MCU is one block
        h, v = (c.h, c.v) if ns > 1 else (1, 1)
        comps.append((h, v, tables >> 4, tables & 15))
        planes.append(frame.coef[idx])
        idxs.append(idx)
    if ns > 1:
        mcus_x = -(-frame.width // (8 * frame.hmax))
        mcus_y = -(-frame.height // (8 * frame.vmax))
    else:
        ch, cw = frame.comp_size(frame.components[idxs[0]])
        mcus_x, mcus_y = -(-cw // 8), -(-ch // 8)
    end, segments = _scan_end(buf, pos)
    decode = _decode_scan_native if native else _decode_scan_python
    decode(buf, segments, frame.restart_interval, comps, planes, frame, mcus_x, mcus_y)
    return end


def _parse_and_decode(buf: bytes, native: bool) -> _Frame:
    if buf[:2] != b'\xff\xd8':
        raise ValueError('not a JPEG stream (no SOI marker)')
    frame = _Frame()
    pos, scans = 2, 0
    while pos < len(buf):
        if buf[pos] != 0xFF:
            pos += 1            # garbage between markers, as libjpeg skips it
            continue
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1            # fill bytes
        if pos >= len(buf):
            break
        marker = buf[pos]
        pos += 1
        if marker == 0xD9:      # EOI
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue            # parameterless
        (length,) = struct.unpack_from('>H', buf, pos)
        seg = buf[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(
                f'{_UNSUPPORTED_SOF[marker]} JPEG is not decoded: octseg_torch decodes '
                f'baseline and extended sequential Huffman JPEG ({ROADMAP_ITEM})')
        if marker in (0xC0, 0xC1):
            precision, height, width, nf = struct.unpack_from('>BHHB', seg, 0)
            if precision != 8:
                raise NotImplementedError(
                    f'{precision}-bit JPEG is not decoded: octseg_torch decodes 8-bit '
                    f'samples ({ROADMAP_ITEM})')
            if height == 0:
                raise NotImplementedError(f'JPEG height from a DNL marker ({ROADMAP_ITEM})')
            if nf not in (1, 3):
                raise NotImplementedError(
                    f'{nf}-component JPEG is not decoded: octseg_torch decodes gray and '
                    f'3-component colour ({ROADMAP_ITEM})')
            frame.height, frame.width = height, width
            frame.components = [Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                                          seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                                for i in range(nf)]
            if any(c.h not in (1, 2, 3, 4) or c.v not in (1, 2, 3, 4)
                   for c in frame.components):
                raise ValueError('bad JPEG sampling factors')
            mcus_x = -(-width // (8 * frame.hmax))
            mcus_y = -(-height // (8 * frame.vmax))
            frame.coef = [np.zeros((mcus_y * c.v, mcus_x * c.h, 64), np.int16)
                          for c in frame.components]
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = np.frombuffer(seg, np.uint8, 16, i + 1)
                n = int(counts.sum())
                slot = 4 * (tc & 1) + (th & 3)
                frame.huff_bits[slot] = 0
                frame.huff_bits[slot, 1:] = counts
                frame.huff_vals[slot] = 0
                frame.huff_vals[slot, :n] = np.frombuffer(seg, np.uint8, n, i + 17)
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg, '>u2', 64, i + 1).astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg, np.uint8, 64, i + 1).astype(np.int64)
                    i += 65
                table = np.empty(64, np.int64)
                table[ZIGZAG] = vals
                frame.qt[tq & 3] = table
        elif marker == 0xDD:
            (frame.restart_interval,) = struct.unpack_from('>H', seg, 0)
        elif marker == 0xE0:
            frame.jfif = frame.jfif or (len(seg) >= 14 and seg[:5] == b'JFIF\x00')
        elif marker == 0xEE:
            if len(seg) >= 12 and seg[:5] == b'Adobe':
                frame.adobe_transform = seg[11]
        elif marker == 0xE1:
            if frame.orientation == 1:
                frame.orientation = _exif_orientation(seg)
        elif marker == 0xDA:
            pos = _decode_scan(frame, buf, seg, pos, native)
            scans += 1
        elif marker == 0xDC:
            raise NotImplementedError(f'JPEG DNL marker ({ROADMAP_ITEM})')
    if not scans:
        raise ValueError('JPEG stream without a scan')
    return frame


# --------------------------- after the entropy stage ------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_FIX = {k: v for k, v in (
    ('0_298631336', 2446), ('0_390180644', 3196), ('0_541196100', 4433),
    ('0_765366865', 6270), ('0_899976223', 7373), ('1_175875602', 9633),
    ('1_501321110', 12299), ('1_847759065', 15137), ('1_961570560', 16069),
    ('2_053119869', 16819), ('2_562915447', 20995), ('3_072711026', 25172))}


def _idct_1d(z: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of jidctint.c's jpeg_idct_islow over 8 int64 arrays (the 8
    inputs of each line); outputs DESCALEd by ``shift``."""
    f = _FIX
    z1 = (z[2] + z[6]) * f['0_541196100']
    tmp2 = z1 + z[6] * -f['1_847759065']
    tmp3 = z1 + z[2] * f['0_765366865']
    tmp0 = (z[0] + z[4]) << _CONST_BITS
    tmp1 = (z[0] - z[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = z[7], z[5], z[3], z[1]
    o1, o2, o3, o4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (o3 + o4) * f['1_175875602']
    t0 = t0 * f['0_298631336']
    t1 = t1 * f['2_053119869']
    t2 = t2 * f['3_072711026']
    t3 = t3 * f['1_501321110']
    o1 = o1 * -f['0_899976223']
    o2 = o2 * -f['2_562915447']
    o3 = o3 * -f['1_961570560'] + z5
    o4 = o4 * -f['0_390180644'] + z5
    t0 = t0 + o1 + o3
    t1 = t1 + o2 + o4
    t2 = t2 + o2 + o3
    t3 = t3 + o1 + o4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return [(o + half) >> shift for o in out]


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (x & 1023) for a centred
    sample x: x + 128 clamped for |x| < 512, wrapping beyond."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(i < 512, 255,
                                                np.where(i < 896, 0, i - 896))).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) int16 coefficients (natural order) and their quantization
    table -> (..., 8, 8) uint8 samples, as jpeg_idct_islow."""
    x = (coef.astype(np.int64) * qt).reshape(*coef.shape[:-1], 8, 8)
    # pass 1: columns (vertical frequencies along axis -2)
    ws = _idct_1d([x[..., k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(ws, axis=-2)
    # pass 2: rows
    out = _idct_1d([ws[..., :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[np.stack(out, axis=-1) & 1023]


def _plane(frame: _Frame, idx: int) -> np.ndarray:
    """The component's samples, cropped to its downsampled size."""
    coef = frame.coef[idx]
    qt = frame.latched_qt.get(idx)
    if qt is None:
        raise ValueError(f'JPEG component {frame.components[idx].ident} has no scan')
    blocks = idct_islow(coef, qt)                       # (bh, bw, 8, 8)
    bh, bw = coef.shape[:2]
    plane = blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
    ch, cw = frame.comp_size(frame.components[idx])
    return plane[:ch, :cw]


def _shift(p: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``p`` moved by one sample along ``axis`` (step -1: each sample's
    predecessor, +1: its successor), the edge sample repeated."""
    n = p.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(p, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        *a.shape[:axis], 2 * a.shape[axis], *a.shape[axis + 1:])


def upsample(plane: np.ndarray, h_expand: int, v_expand: int) -> np.ndarray:
    """jdsample.c with fancy upsampling: a (rows, cols) uint8 plane at its
    downsampled size -> (rows * v_expand, cols * h_expand)."""
    p = plane.astype(np.int32)
    cols = p.shape[1]
    if (h_expand, v_expand) == (2, 1) and cols > 2:
        return _interleave((3 * p + _shift(p, 1, -1) + 1) >> 2,
                           (3 * p + _shift(p, 1, 1) + 2) >> 2, 1).astype(np.uint8)
    if (h_expand, v_expand) == (1, 2):
        return _interleave((3 * p + _shift(p, 0, -1) + 1) >> 2,
                           (3 * p + _shift(p, 0, 1) + 2) >> 2, 0).astype(np.uint8)
    if (h_expand, v_expand) == (2, 2) and cols > 2:
        rows = []
        for near_far in (3 * p + _shift(p, 0, -1), 3 * p + _shift(p, 0, 1)):
            c = near_far
            rows.append(_interleave((3 * c + _shift(c, 1, -1) + 8) >> 4,
                                    (3 * c + _shift(c, 1, 1) + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0).astype(np.uint8)
    return np.repeat(np.repeat(plane, v_expand, axis=0), h_expand, axis=1)


def _ycc_tables():
    scale, half = 16, 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << scale) + 0.5)

    cr_r = (fix(1.40200) * x + half) >> scale
    cb_b = (fix(1.77200) * x + half) >> scale
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: (H, W) uint8 planes -> (H, W, 3) RGB."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _colour_space(frame: _Frame) -> str:
    """libjpeg's jpeg_color_space guess for a 3-component frame."""
    if frame.jfif:
        return 'YCbCr'
    if frame.adobe_transform is not None:
        return 'RGB' if frame.adobe_transform == 0 else 'YCbCr'
    ids = tuple(c.ident for c in frame.components)
    return 'RGB' if ids == (82, 71, 66) else 'YCbCr'


def _assemble(frame: _Frame) -> np.ndarray:
    hmax, vmax = frame.hmax, frame.vmax
    full = []
    for idx, c in enumerate(frame.components):
        if hmax % c.h or vmax % c.v:
            raise NotImplementedError(
                f'fractional JPEG sampling ({c.h}x{c.v} of {hmax}x{vmax}) is not decoded, '
                f'as libjpeg does not ({ROADMAP_ITEM})')
        up = upsample(_plane(frame, idx), hmax // c.h, vmax // c.v)
        full.append(up[:frame.height, :frame.width])
    if len(full) == 1:
        return full[0]
    if _colour_space(frame) == 'RGB':
        return np.stack(full, axis=-1)
    return ycc_to_rgb(*full)


def decode_jpeg(data: bytes, native: bool = True, orient: bool = False) -> np.ndarray:
    """A JPEG stream -> (H, W, 3) RGB uint8, or (H, W) for one component, as
    libjpeg-turbo decodes it by default (``PIL.Image.open`` and
    ``cv2.imdecode(..., IMREAD_UNCHANGED)`` give the same, cv2 in BGR).
    ``native``: the C++ entropy decoder (built with g++ at first use; a
    failed build raises); False: its plain Python version. ``orient``: apply
    the EXIF orientation, as ``cv2.imread`` does."""
    frame = _parse_and_decode(bytes(data), native)
    img = _assemble(frame)
    return apply_orientation(img, frame.orientation) if orient else img


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied to an (H, W[, C]) image; other values
    leave it as it is."""
    ops = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: a.swapaxes(0, 1)[:, ::-1], 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: a.swapaxes(0, 1)[::-1]}
    return np.ascontiguousarray(ops.get(orientation, ops[1])(img))
