"""JPEG decoding, bit-exact with libjpeg-turbo's default decode.

octseg reads JPEG files and JPEG-compressed DICOM frames through
``cv2.imdecode``/``cv2.imread`` and ``PIL.Image.open``, both libjpeg-turbo
with its defaults. This module reproduces that decode without either:

- sequential (SOF0, SOF1) and progressive (SOF2) Huffman streams at 8-bit
  precision, 1, 3 or 4 components, any integral sampling factors, restart
  intervals (DRI), several DHT and DQT segments, several scans; a
  progressive scan may be DC first or refine, AC first (EOB runs) or AC
  refine (correction bits), and the coefficients add up over the scans;
- lossless Huffman streams (SOF3) at 2 to 8 bits, predictors 1-7, a point
  transform, 1, 3 or 4 components at 1x1 sampling, interleaved or one scan
  per component, restart intervals of whole rows; the samples come out as
  coded, with no colour conversion;
- dequantization and the islow IDCT of ``jidctint.c`` (13-bit constants,
  2 pass-1 bits) with its 1024-entry range-limit table;
- the upsampling of ``jdsample.c`` with ``do_fancy_upsampling``: triangle
  filters for h2v1 and h2v2 (chroma at least 3 samples wide) and for h1v2,
  each with its alternating rounding biases and the last real row and
  column repeated at the edges; replication for every other factor;
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c``;
- libjpeg's colour-space guess for 3 components: a JFIF marker means YCbCr,
  an Adobe marker with transform 0 RGB (1 or other: YCbCr), component ids
  'R', 'G', 'B' RGB, anything else YCbCr (RGB in a lossless stream); for 4
  components an Adobe transform 0, or no Adobe marker, means CMYK. CMYK
  comes out as cv2 makes it (``decode_jpeg``: three channels by cv2's
  ``icvCvt_CMYK2BGR_8u_C4C3R``) or as PIL holds it (``decode_jpeg_pil``:
  libjpeg's samples inverted).

Forms libjpeg-turbo refuses as well, so that cv2.imdecode returns None and
PIL cannot identify the file, raise ``UndecodableJPEG``: hierarchical
(SOF5-7, SOF13-15) and arithmetic lossless (SOF11) streams, DCT samples of
other than 8 bits, lossless ones of more than 8, 2 or more than 4
components, a height left to a DNL marker, a lossless restart interval of
part of a row, colour conversion in a lossless stream, reserved markers and
scan parameters libjpeg rejects. Forms libjpeg-turbo decodes and this
module does not yet raise NotImplementedError (ROADMAP.md, "JPEG forms and
image modes octseg reads through cv2 and PIL"): arithmetic-coded streams
(SOF9, SOF10), YCCK, lossless with subsampled components, and a
progressive scan script that leaves one of the first ten coefficients
short of full precision, which libjpeg-turbo's block smoothing
(``jdcoefct.c``) would change.

The entropy stage (Huffman codes and restart segments to int16 coefficient
blocks, or to lossless samples) has two implementations:
``csrc/jpeg_entropy.cc``, host C++ built with g++ at first use and loaded
with ctypes, which ``decode_jpeg`` uses by default, and the
``_decode_*_python`` functions, its plain versions, which the tests hold it
to. Everything after that stage is numpy shared by both.
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

# frame markers libjpeg-turbo decodes and the port does not yet
_NOT_YET_SOF = {0xC9: 'arithmetic-coded (SOF9)', 0xCA: 'arithmetic-coded progressive (SOF10)'}
# frame markers libjpeg-turbo refuses
_UNDECODABLE_SOF = {
    0xC5: 'differential (SOF5)', 0xC6: 'differential progressive (SOF6)',
    0xC7: 'differential lossless (SOF7)', 0xC8: 'JPG (reserved)',
    0xCB: 'arithmetic-coded lossless (SOF11)', 0xCD: 'differential arithmetic (SOF13)',
    0xCE: 'differential arithmetic progressive (SOF14)',
    0xCF: 'differential arithmetic lossless (SOF15)',
}
_MODES = {0xC0: 'sequential', 0xC1: 'sequential', 0xC2: 'progressive', 0xC3: 'lossless'}
# how many zigzag coefficients decide libjpeg-turbo's block smoothing
# (jdcoefct.c's SAVED_COEFS)
_SMOOTHED = 10


class UndecodableJPEG(ValueError):
    """A JPEG form libjpeg-turbo does not decode either (cv2.imdecode
    returns None, PIL cannot identify it)."""


def _not_yet(what: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} is not decoded by octseg_torch yet, though libjpeg-turbo decodes it '
        f'({ROADMAP_ITEM})')


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
        self.mode = 'sequential'                  # or 'progressive', 'lossless'
        self.precision = 8
        # progressive: per component, the Al of the last scan of each zigzag
        # coefficient (-1: none yet), libjpeg's coef_bits
        self.coef_bits: List[np.ndarray] = []
        self.samples: List[np.ndarray] = []       # lossless: per component (H, W) uint8

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


class _BitReader:
    """One restart segment's bits, read as csrc/jpeg_entropy.cc reads them."""

    def __init__(self, seg: bytes):
        self.d = _segment_bytes(seg)
        self.pos = 0

    def _window(self) -> int:
        """24 bits from the byte of ``pos``, shifted so that bit 23 + (pos & 7)
        is the next one."""
        i = self.pos >> 3
        if i + 3 > len(self.d):
            self.d += bytes(8)      # zero bits past the end
        d = self.d
        return (d[i] << 16 | d[i + 1] << 8 | d[i + 2]) << (self.pos & 7)

    def bits(self, n: int) -> int:
        v = self._window() >> (24 - n) & ((1 << n) - 1)
        self.pos += n
        return v

    def huffman(self, lut: List[int]) -> int:
        e = lut[self._window() >> 8 & 0xFFFF]
        if e == 0:
            raise ValueError('corrupt JPEG data: bad Huffman code')
        self.pos += e >> 8
        return e & 0xFF

    def extend(self, s: int) -> int:
        if s == 0:
            return 0
        v = self.bits(s)
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _int16(v: int) -> int:
    """``v`` stored in libjpeg's 16-bit JCOEF."""
    return (v + 32768) % 65536 - 32768


def _blocks(planes: List[np.ndarray], comps, mcus_x: int, mcus_y: int,
            segments: List[Tuple[int, int]], restart: int):
    """(segment index, component, block (64,) view) in decode order: each
    restart segment's MCUs in raster order, each MCU's components, each
    component's v x h blocks."""
    total = mcus_x * mcus_y
    per_segment = restart if restart > 0 else total
    flat = [p.reshape(-1, 64) for p in planes]
    mcu = 0
    for s in range(len(segments)):
        for _ in range(min(per_segment, total - mcu)):
            my, mx = divmod(mcu, mcus_x)
            for c, (h, v, _td, _ta) in enumerate(comps):
                bw = planes[c].shape[1]
                for by in range(v):
                    for bx in range(h):
                        yield s, c, flat[c][(my * v + by) * bw + mx * h + bx]
            mcu += 1
        if mcu >= total:
            return


def _decode_scan_python(data: bytes, segments: List[Tuple[int, int]], restart: int,
                        comps, planes: List[np.ndarray], frame: _Frame,
                        mcus_x: int, mcus_y: int) -> None:
    """The plain version of ``csrc/jpeg_entropy.cc``'s sequential decoder:
    decode one scan's Huffman-coded blocks into ``planes`` (one (bh, bw, 64)
    int16 array per scan component). ``comps``: (h, v, dc slot, ac slot)
    per component."""
    dc_luts = [_huffman_lut(frame.huff_bits[td], frame.huff_vals[td]) for _h, _v, td, _ta in comps]
    ac_luts = [_huffman_lut(frame.huff_bits[4 + ta], frame.huff_vals[4 + ta])
               for _h, _v, _td, ta in comps]
    zigzag = ZIGZAG.tolist()
    seg, br, pred = -1, None, []
    for s, c, block in _blocks(planes, comps, mcus_x, mcus_y, segments, restart):
        if s != seg:            # a new restart segment: DC predictions restart
            seg, br, pred = s, _BitReader(data[slice(*segments[s])]), [0] * len(comps)
        block[:] = 0
        t = br.huffman(dc_luts[c])
        if t > 16:
            raise ValueError('corrupt JPEG data: bad DC category')
        pred[c] += br.extend(t)
        block[0] = pred[c]
        k = 1
        while k < 64:
            rs = br.huffman(ac_luts[c])
            r, sz = rs >> 4, rs & 15
            if sz == 0:
                if r != 15:
                    break
                k += 16
                continue
            k += r
            val = br.extend(sz)
            if k > 63:
                break
            block[zigzag[k]] = val
            k += 1


def _refine_block(br: _BitReader, lut: List[int], block: np.ndarray, ss: int, se: int,
                  al: int, eobrun: int, natural: List[int]) -> int:
    """One block of an AC refinement scan (jdphuff.c decode_mcu_AC_refine);
    returns the EOB run left."""
    p1, m1 = 1 << al, -(1 << al)

    def correct(z: int) -> None:
        if br.bits(1) and (int(block[z]) & p1) == 0:
            block[z] += p1 if block[z] >= 0 else m1

    k = ss
    if eobrun == 0:
        while k <= se:
            rs = br.huffman(lut)
            r, sz, v = rs >> 4, rs & 15, 0
            if sz:
                v = p1 if br.bits(1) else m1      # a newly nonzero coefficient
            elif r != 15:
                eobrun = (1 << r) + (br.bits(r) if r else 0)
                break
            # skip r zero coefficients, correcting the nonzero ones met
            while True:
                z = natural[k]
                if block[z] != 0:
                    correct(z)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > se:
                    break
            if v:
                block[natural[k]] = v
            k += 1
    if eobrun > 0:
        for k in range(k, se + 1):  # the band's rest: correction bits only
            if block[natural[k]] != 0:
                correct(natural[k])
        eobrun -= 1
    return eobrun


def _decode_progressive_python(data: bytes, segments: List[Tuple[int, int]], restart: int,
                               comps, planes: List[np.ndarray], frame: _Frame,
                               mcus_x: int, mcus_y: int, ss: int, se: int, ah: int,
                               al: int) -> None:
    """The plain version of ``csrc/jpeg_entropy.cc``'s progressive decoder:
    one scan of band ``ss``..``se`` with successive-approximation bits
    ``ah``, ``al``, added to what ``planes`` hold."""
    if ss == 0:
        luts = [None if ah else _huffman_lut(frame.huff_bits[td], frame.huff_vals[td])
                for _h, _v, td, _ta in comps]
    else:
        luts = [_huffman_lut(frame.huff_bits[4 + ta], frame.huff_vals[4 + ta])
                for _h, _v, _td, ta in comps]
    natural = ZIGZAG.tolist() + [63] * 16   # libjpeg's guard entries
    seg, br, pred, eobrun = -1, None, [], 0
    for s, c, block in _blocks(planes, comps, mcus_x, mcus_y, segments, restart):
        if s != seg:            # a new restart segment: DC and EOB run restart
            seg, br, pred, eobrun = s, _BitReader(data[slice(*segments[s])]), [0] * len(comps), 0
        if ss == 0 and ah == 0:
            t = br.huffman(luts[c])
            if t > 16:
                raise ValueError('corrupt JPEG data: bad DC category')
            pred[c] += br.extend(t)
            block[0] = _int16(pred[c] << al)
        elif ss == 0:
            if br.bits(1):
                block[0] |= 1 << al
        elif ah == 0:
            if eobrun > 0:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                rs = br.huffman(luts[c])
                r, sz = rs >> 4, rs & 15
                if sz:
                    k += r
                    block[natural[k]] = _int16(br.extend(sz) << al)
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + (br.bits(r) if r else 0) - 1
                    break
                k += 1
        else:
            eobrun = _refine_block(br, luts[c], block, ss, se, al, eobrun, natural)


_PREDICTORS = {
    1: lambda ra, rb, rc: ra, 2: lambda ra, rb, rc: rb, 3: lambda ra, rb, rc: rc,
    4: lambda ra, rb, rc: ra + rb - rc, 5: lambda ra, rb, rc: ra + ((rb - rc) >> 1),
    6: lambda ra, rb, rc: rb + ((ra - rc) >> 1), 7: lambda ra, rb, rc: (ra + rb) >> 1,
}


def _decode_lossless_python(data: bytes, segments: List[Tuple[int, int]],
                            rows_per_segment: int, comps, planes: List[np.ndarray],
                            frame: _Frame, predictor: int, pt: int) -> None:
    """The plain version of ``csrc/jpeg_entropy.cc``'s lossless decoder: one
    scan into ``planes`` ((H, W) uint8 per scan component)."""
    luts = [_huffman_lut(frame.huff_bits[td], frame.huff_vals[td]) for _h, _v, td, _ta in comps]
    height, width = planes[0].shape
    rows = rows_per_segment or height
    initial = 1 << (frame.precision - pt - 1)
    predict = _PREDICTORS[predictor]
    prev = [[0] * width for _ in comps]
    y = 0
    for start, end in segments:
        br = _BitReader(data[start:end])
        for r in range(min(rows, height - y)):
            diff = [[0] * width for _ in comps]
            for x in range(width):
                for c in range(len(comps)):
                    t = br.huffman(luts[c])
                    if t > 16:
                        raise ValueError('corrupt JPEG data: bad difference category')
                    diff[c][x] = 32768 if t == 16 else br.extend(t)
            for c, d in enumerate(diff):
                out = [0] * width
                out[0] = (d[0] + (initial if r == 0 else prev[c][0])) & 0xFFFF
                for x in range(1, width):
                    p = out[x - 1] if r == 0 else predict(out[x - 1], prev[c][x], prev[c][x - 1])
                    out[x] = (d[x] + p) & 0xFFFF
                planes[c][y] = [(v << pt) & 0xFF for v in out]
                prev[c] = out
            y += 1
        if y >= height:
            return


_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of csrc/jpeg_entropy.cc's entry points
_SIGNATURES = {
    'octseg_jpeg_decode_scan': [_P] * 3 + [_I] * 3 + [_P] * 8 + [_I] * 2,
    'octseg_jpeg_decode_progressive_scan': [_P] * 3 + [_I] * 3 + [_P] * 8 + [_I] * 6,
    'octseg_jpeg_decode_lossless_scan': [_P] * 3 + [_I] * 5 + [_P] * 4 + [_I] * 3,
}


def _entropy_library() -> ctypes.CDLL:
    from octseg_torch.ops.kernels import _build

    lib = _build.load_host('jpeg_entropy')
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def _call_native(name: str, data: bytes, segments: List[Tuple[int, int]], *args) -> None:
    """Call ``name`` of csrc/jpeg_entropy.cc on the scan's bytes and
    segments; numpy arrays among ``args`` go by pointer, a list of them as
    an array of pointers."""
    fn = getattr(_entropy_library(), name)
    buf = np.frombuffer(data, np.uint8)
    starts = np.array([s for s, _e in segments], np.int64)
    ends = np.array([e for _s, e in segments], np.int64)
    keep = [buf, starts, ends]
    call = [buf.ctypes.data, starts.ctypes.data, ends.ctypes.data, len(segments)]
    for a in args:
        if isinstance(a, list):
            ptrs = (ctypes.c_void_p * len(a))(*[p.ctypes.data for p in a])
            keep.append(ptrs)
            call.append(ctypes.cast(ptrs, ctypes.c_void_p))
        elif isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a)
            keep.append(a)
            call.append(a.ctypes.data)
        else:
            call.append(a)
    rc = fn(*call)
    if rc != 0:
        raise ValueError({-1: 'corrupt JPEG data: bad Huffman code',
                          -2: 'bad Huffman table'}.get(rc, f'entropy decoder error {rc}'))


def _scan_arrays(comps, planes: List[np.ndarray]):
    """h, v, blocks_w, dc slots, ac slots as int32 arrays."""
    cols = [np.array(col, np.int32) for col in zip(*comps)]
    return cols[0], cols[1], np.array([p.shape[1] for p in planes], np.int32), cols[2], cols[3]


def _decode_scan_native(data: bytes, segments: List[Tuple[int, int]], restart: int,
                        comps, planes: List[np.ndarray], frame: _Frame,
                        mcus_x: int, mcus_y: int) -> None:
    """``_decode_scan_python``'s contract, in ``csrc/jpeg_entropy.cc``."""
    h, v, bw, td, ta = _scan_arrays(comps, planes)
    _call_native('octseg_jpeg_decode_scan', data, segments, restart, len(planes), h, v, bw,
                 planes, td, ta, frame.huff_bits, frame.huff_vals, mcus_x, mcus_y)


def _decode_progressive_native(data: bytes, segments: List[Tuple[int, int]], restart: int,
                               comps, planes: List[np.ndarray], frame: _Frame,
                               mcus_x: int, mcus_y: int, ss: int, se: int, ah: int,
                               al: int) -> None:
    """``_decode_progressive_python``'s contract, in ``csrc/jpeg_entropy.cc``."""
    h, v, bw, td, ta = _scan_arrays(comps, planes)
    _call_native('octseg_jpeg_decode_progressive_scan', data, segments, restart, len(planes),
                 h, v, bw, planes, td, ta, frame.huff_bits, frame.huff_vals, mcus_x, mcus_y,
                 ss, se, ah, al)


def _decode_lossless_native(data: bytes, segments: List[Tuple[int, int]],
                            rows_per_segment: int, comps, planes: List[np.ndarray],
                            frame: _Frame, predictor: int, pt: int) -> None:
    """``_decode_lossless_python``'s contract, in ``csrc/jpeg_entropy.cc``."""
    td = np.array([c[2] for c in comps], np.int32)
    height, width = planes[0].shape
    _call_native('octseg_jpeg_decode_lossless_scan', data, segments, rows_per_segment,
                 len(planes), width, height, planes, td, frame.huff_bits, frame.huff_vals,
                 predictor, pt, frame.precision)


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


def _check_dc_symbols(frame: _Frame, slots, most: int) -> None:
    """libjpeg refuses a DC (or lossless) table with a symbol above ``most``."""
    for t in slots:
        n = int(frame.huff_bits[t, 1:].sum())
        if (frame.huff_vals[t, :n] > most).any():
            raise UndecodableJPEG(f'JPEG DC Huffman table {t} has a symbol above {most}')


def _check_progression(ns: int, ss: int, se: int, ah: int, al: int) -> None:
    """jdphuff.c's scan parameter checks."""
    bad = se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)
    if (ah != 0 and al != ah - 1) or al > 13 or bad:
        raise UndecodableJPEG(f'bad progressive JPEG scan: Ss={ss} Se={se} Ah={ah} Al={al}')


def _lossless_scan(frame: _Frame, buf: bytes, segments, comps, idxs,
                   ss: int, se: int, ah: int, al: int, native: bool) -> None:
    if ss < 1 or ss > 7 or se != 0 or ah != 0 or al >= frame.precision:
        raise UndecodableJPEG(f'bad lossless JPEG scan: Ss={ss} Se={se} Ah={ah} Al={al}')
    if frame.hmax != 1 or frame.vmax != 1:
        raise _not_yet('lossless JPEG with subsampled components')
    _check_dc_symbols(frame, {c[2] for c in comps}, 16)
    restart = frame.restart_interval
    if restart % frame.width:
        raise UndecodableJPEG(f'lossless JPEG restart interval {restart} is not a multiple '
                              f'of the row ({frame.width} samples)')
    if not frame.samples:
        frame.samples = [np.zeros((frame.height, frame.width), np.uint8)
                         for _ in frame.components]
    planes = [frame.samples[i] for i in idxs]
    decode = _decode_lossless_native if native else _decode_lossless_python
    decode(buf, segments, restart // frame.width, comps, planes, frame, ss, al)


def _decode_scan(frame: _Frame, buf: bytes, seg: bytes, pos: int, native: bool) -> int:
    """Parse one SOS segment and decode its scan; returns the offset of the
    marker after the scan."""
    if not frame.components:
        raise ValueError('JPEG scan before its frame header')
    ns = seg[0]
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    lossless = frame.mode == 'lossless'
    comps, planes, idxs = [], [], []
    for i in range(ns):
        cs, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        idx = next((k for k, c in enumerate(frame.components) if c.ident == cs), None)
        if idx is None:
            raise ValueError(f'JPEG scan names component {cs}, which the frame lacks')
        c = frame.components[idx]
        if not lossless:
            if c.tq not in frame.qt:
                raise ValueError(f'JPEG component {cs} uses quantization table {c.tq}, '
                                 f'which is not defined')
            # libjpeg latches a component's table at its first scan
            frame.latched_qt.setdefault(idx, frame.qt[c.tq].copy())
            planes.append(frame.coef[idx])
        # a scan of one component is not interleaved: its MCU is one block
        h, v = (c.h, c.v) if ns > 1 else (1, 1)
        comps.append((h, v, tables >> 4, tables & 15))
        idxs.append(idx)
    end, segments = _scan_end(buf, pos)
    if lossless:
        _lossless_scan(frame, buf, segments, comps, idxs, ss, se, ah, al, native)
        return end
    if ns > 1:
        mcus_x = -(-frame.width // (8 * frame.hmax))
        mcus_y = -(-frame.height // (8 * frame.vmax))
    else:
        ch, cw = frame.comp_size(frame.components[idxs[0]])
        mcus_x, mcus_y = -(-cw // 8), -(-ch // 8)
    if frame.mode == 'sequential':
        _check_dc_symbols(frame, {c[2] for c in comps}, 15)
        decode = _decode_scan_native if native else _decode_scan_python
        decode(buf, segments, frame.restart_interval, comps, planes, frame, mcus_x, mcus_y)
        return end
    _check_progression(ns, ss, se, ah, al)
    if ss == 0 and ah == 0:
        _check_dc_symbols(frame, {c[2] for c in comps}, 15)
    for idx in idxs:
        frame.coef_bits[idx][ss:se + 1] = al
    decode = _decode_progressive_native if native else _decode_progressive_python
    decode(buf, segments, frame.restart_interval, comps, planes, frame, mcus_x, mcus_y,
           ss, se, ah, al)
    return end


def _start_frame(frame: _Frame, marker: int, seg: bytes) -> None:
    """An SOF0-3 segment: the frame header, checked as libjpeg-turbo checks
    it, and the coefficient planes."""
    precision, height, width, nf = struct.unpack_from('>BHHB', seg, 0)
    frame.mode = _MODES[marker]
    if frame.mode == 'lossless' and not 2 <= precision <= 8:
        raise UndecodableJPEG(f'{precision}-bit lossless JPEG (cv2 and PIL decode 2 to 8 bits)')
    if frame.mode != 'lossless' and precision != 8:
        raise UndecodableJPEG(f'{precision}-bit DCT JPEG (cv2 and PIL decode 8 bits)')
    if height == 0 or width == 0:
        raise UndecodableJPEG('JPEG height from a DNL marker, or an empty image')
    if nf not in (1, 3, 4):
        raise UndecodableJPEG(f'{nf}-component JPEG (cv2 and PIL decode 1, 3 or 4)')
    frame.precision, frame.height, frame.width = precision, height, width
    frame.components = [Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                                  seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                        for i in range(nf)]
    if any(c.h not in (1, 2, 3, 4) or c.v not in (1, 2, 3, 4) for c in frame.components):
        raise ValueError('bad JPEG sampling factors')
    if frame.mode == 'lossless':
        return
    mcus_x = -(-width // (8 * frame.hmax))
    mcus_y = -(-height // (8 * frame.vmax))
    frame.coef = [np.zeros((mcus_y * c.v, mcus_x * c.h, 64), np.int16)
                  for c in frame.components]
    frame.coef_bits = [np.full(64, -1, np.int64) for _ in frame.components]


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
        if marker in _UNDECODABLE_SOF or marker in (0xDE, 0xDF) or 0xF0 <= marker <= 0xFD \
                or 0x02 <= marker <= 0xBF:
            raise UndecodableJPEG(
                f'JPEG marker 0x{marker:02X} '
                f'({_UNDECODABLE_SOF.get(marker, "reserved or hierarchical")})')
        if marker in _NOT_YET_SOF:
            raise _not_yet(f'{_NOT_YET_SOF[marker]} JPEG')
        (length,) = struct.unpack_from('>H', buf, pos)
        seg = buf[pos + 2:pos + length]
        pos += length
        if marker in _MODES:
            _start_frame(frame, marker, seg)
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
    if not scans:
        raise ValueError('JPEG stream without a scan')
    return frame


def _check_smoothing(frame: _Frame) -> None:
    """libjpeg-turbo smooths a progressive image's blocks (jdcoefct.c
    ``smoothing_ok``) when every component has a DC scan and nonzero
    quantizers for its first ten coefficients, and a scan script left one
    of those coefficients in any component short of full precision."""
    ok = all(frame.coef_bits[i][0] >= 0 and i in frame.latched_qt
             and (frame.latched_qt[i][ZIGZAG[:_SMOOTHED]] != 0).all()
             for i in range(len(frame.components)))
    if ok and any((b[1:_SMOOTHED] != 0).any() for b in frame.coef_bits):
        raise _not_yet('a progressive JPEG whose scans leave one of the first ten '
                       'coefficients short of full precision (libjpeg-turbo smooths its '
                       'blocks)')


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
    """libjpeg-turbo's jpeg_color_space guess for 3 and 4 components."""
    if len(frame.components) == 4:
        return 'CMYK' if frame.adobe_transform in (None, 0) else 'YCCK'
    if frame.jfif:
        return 'YCbCr'
    if frame.adobe_transform is not None:
        return 'RGB' if frame.adobe_transform == 0 else 'YCbCr'
    ids = tuple(c.ident for c in frame.components)
    return 'RGB' if ids == (82, 71, 66) or frame.mode == 'lossless' else 'YCbCr'


def _assemble(frame: _Frame) -> np.ndarray:
    if frame.mode == 'lossless':
        full = frame.samples
    else:
        if frame.mode == 'progressive':
            _check_smoothing(frame)
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
    space = _colour_space(frame)
    if frame.mode == 'lossless' and space not in ('RGB', 'CMYK'):
        raise UndecodableJPEG(f'{space} in a lossless JPEG (libjpeg-turbo converts no colour '
                              f'there)')
    if space == 'YCCK':
        raise _not_yet('YCCK JPEG (Adobe transform 2)')
    if space in ('RGB', 'CMYK'):
        return np.stack(full, axis=-1)
    return ycc_to_rgb(*full)


def cmyk_to_rgb_cv2(cmyk: np.ndarray) -> np.ndarray:
    """(H, W, 4) CMYK samples as libjpeg hands them over -> (H, W, 3) RGB, as
    cv2's icvCvt_CMYK2BGR_8u_C4C3R makes them (in BGR): each of C, M, Y
    becomes k - ((255 - x) * k >> 8)."""
    x = cmyk.astype(np.int32)
    k = x[..., 3:]
    return (k - ((255 - x[..., :3]) * k >> 8)).astype(np.uint8)


def decode_jpeg(data: bytes, native: bool = True, orient: bool = False) -> np.ndarray:
    """A JPEG stream -> (H, W, 3) RGB uint8, or (H, W) for one component, as
    libjpeg-turbo decodes it by default (``PIL.Image.open`` and
    ``cv2.imdecode(..., IMREAD_UNCHANGED)`` give the same, cv2 in BGR); a
    CMYK stream as cv2 converts it to three channels. ``native``: the C++
    entropy decoder (built with g++ at first use; a failed build raises);
    False: its plain Python version. ``orient``: apply the EXIF orientation,
    as ``cv2.imread`` does. Raises UndecodableJPEG for what libjpeg-turbo
    refuses too, NotImplementedError for what it decodes and this module
    does not yet."""
    frame = _parse_and_decode(bytes(data), native)
    img = _assemble(frame)
    if img.ndim == 3 and img.shape[2] == 4:
        img = cmyk_to_rgb_cv2(img)
    return apply_orientation(img, frame.orientation) if orient else img


def decode_jpeg_pil(data: bytes) -> Tuple[str, np.ndarray]:
    """(mode, pixels) as ``PIL.Image.open`` holds a JPEG stream: 'L', 'RGB',
    or 'CMYK' with libjpeg's samples inverted (Pillow's 'CMYK;I' raw mode).
    PIL reads 8-bit samples only, so a lossless stream of fewer bits, which
    cv2 decodes, raises UndecodableJPEG here."""
    frame = _parse_and_decode(bytes(data), True)
    if frame.precision != 8:
        raise UndecodableJPEG(f'{frame.precision}-bit JPEG (PIL reads 8-bit samples only)')
    img = _assemble(frame)
    if img.ndim == 2:
        return 'L', img
    return ('CMYK', 255 - img) if img.shape[2] == 4 else ('RGB', img)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied to an (H, W[, C]) image; other values
    leave it as it is."""
    ops = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: a.swapaxes(0, 1)[:, ::-1], 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: a.swapaxes(0, 1)[::-1]}
    return np.ascontiguousarray(ops.get(orientation, ops[1])(img))
