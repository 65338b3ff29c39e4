"""Small JPEG encoders for the forms cv2 and PIL do not write: lossless
(SOF3) at any precision, predictor, point transform, restart interval and
component count, and DC-only DCT streams (SOF1) at 8 or 12 bits with
1 to 4 components. Plus byte patches of existing streams (a frame marker, an
Adobe transform, scans cut off), and a writer of DICOM files whose pixel
data is encapsulated.

numpy and the standard library only, vectorized per image, so that
``chip_smoke.py`` writes a lossless pullback with it on a machine without
cv2 or PIL. Each stream has one scan (all components interleaved) unless
``scans`` says otherwise.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

# one DC/lossless table for the categories 0-16: lengths 2, 3 (x5), 4 .. 14
_DC_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
_DC_VALS = list(range(17))
# the DCT DC table: categories 0-15 (libjpeg refuses a DC symbol above 15)
_DCT_DC_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0]
_DCT_DC_VALS = list(range(16))
# an AC table holding only EOB
_AC_BITS = [0, 1] + [0] * 15
_AC_VALS = [0]


def _canonical(bits: Sequence[int], vals: Sequence[int]):
    """(code, length) per symbol, as JPEG builds a canonical code."""
    codes = {}
    code = k = 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


_DC_CODES = _canonical(_DC_BITS, _DC_VALS)
_DC_CODE = np.array([_DC_CODES[s][0] for s in range(17)], np.uint64)
_DC_LEN = np.array([_DC_CODES[s][1] for s in range(17)], np.int64)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack('>BBH', 0xFF, marker, len(payload) + 2) + payload


def _dht(tc: int, th: int, bits: Sequence[int], vals: Sequence[int]) -> bytes:
    return _segment(0xC4, bytes([tc << 4 | th]) + bytes(bits[1:17]) + bytes(vals))


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Bit strings (``values``, each ``lengths`` bits long, at most 32) in
    order, padded with 1 bits to a byte and FF-stuffed."""
    lengths = lengths.astype(np.int64)
    keep = lengths > 0
    values, lengths = values[keep].astype(np.uint64), lengths[keep]
    aligned = (values << (32 - lengths).astype(np.uint64)).astype('>u4')
    bits = np.unpackbits(aligned.view(np.uint8).reshape(-1, 4), axis=1)
    bits = bits[np.arange(32)[None, :] < lengths[:, None]]
    bits = np.concatenate([bits, np.ones(-bits.size % 8, np.uint8)])
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _category(diff: np.ndarray) -> np.ndarray:
    """The magnitude category of each difference (0 for 0)."""
    mag = np.abs(diff).astype(np.int64)
    cat = np.zeros(mag.shape, np.int64)
    for s in range(1, 17):
        cat[mag >= (1 << (s - 1))] = s
    return cat


def _code_differences(diff: np.ndarray, lossless: bool):
    """(values, lengths) of each difference's Huffman code and extra bits; a
    lossless difference of 32768 (mod 2**16) is category 16, no extra bits."""
    diff = diff.astype(np.int64)
    if lossless:
        diff = (diff + 32768) % 65536 - 32768
    cat = _category(diff)
    if lossless:
        cat = np.where(diff == -32768, 16, cat)
    extra = np.where(diff < 0, diff + (1 << cat) - 1, diff)
    extra_len = np.where(cat == 16, 0, cat)
    extra = np.where(cat == 16, 0, extra) & ((1 << extra_len) - 1)
    values = (_DC_CODE[cat].astype(np.uint64) << extra_len.astype(np.uint64)) \
        | extra.astype(np.uint64)
    return values, _DC_LEN[cat] + extra_len


def _predict(x: np.ndarray, predictor: int, first_rows: np.ndarray, initial: int) -> np.ndarray:
    """Lossless predictions for (H, W) samples ``x``: rows flagged in
    ``first_rows`` (the first row and each row after a restart) start from
    ``initial`` and predict from the left; the first column of other rows
    from above."""
    x = x.astype(np.int64)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    pred[first_rows] = ra[first_rows]
    pred[first_rows, 0] = initial
    return pred


def _header(width: int, height: int, ids: Sequence[int], sampling: Sequence[int],
            sof: int, precision: int, jfif: bool, adobe: Optional[int]) -> bytes:
    out = b'\xff\xd8'
    if jfif:
        out += _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    if adobe is not None:
        out += _segment(0xEE, b'Adobe' + struct.pack('>HHHB', 100, 0, 0, adobe))
    comps = b''.join(bytes([i, s, 0]) for i, s in zip(ids, sampling))
    out += _segment(sof, struct.pack('>BHHB', precision, height, width, len(ids)) + comps)
    return out


def encode_lossless(img: np.ndarray, predictor: int = 1, pt: int = 0, precision: int = 8,
                    restart_rows: int = 0, ids: Optional[Sequence[int]] = None,
                    adobe: Optional[int] = None, jfif: bool = False,
                    scans: str = 'interleaved') -> bytes:
    """A lossless Huffman JPEG (SOF3) of (H, W) or (H, W, C) ``img`` (values
    below 2**precision; the low ``pt`` bits are dropped by the point
    transform). ``restart_rows``: a restart interval of that many rows (0:
    none). ``scans``: 'interleaved' (one scan) or 'separate' (one scan per
    component)."""
    planes = img[..., None] if img.ndim == 2 else img
    h, w, nc = planes.shape
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    x = planes.astype(np.int64) >> pt
    first_rows = np.zeros(h, bool)
    first_rows[::restart_rows if restart_rows else h] = True
    initial = 1 << (precision - pt - 1)
    diffs = np.stack([x[..., c] - _predict(x[..., c], predictor, first_rows, initial)
                      for c in range(nc)], axis=-1)
    out = _header(w, h, ids, [0x11] * nc, 0xC3, precision, jfif, adobe)
    out += _dht(0, 0, _DC_BITS, _DC_VALS)
    if restart_rows:
        out += _segment(0xDD, struct.pack('>H', restart_rows * w))
    groups = [list(range(nc))] if scans == 'interleaved' else [[c] for c in range(nc)]
    for group in groups:
        sos = bytes([len(group)]) + b''.join(bytes([ids[c], 0x00]) for c in group)
        out += _segment(0xDA, sos + bytes([predictor, 0, pt]))
        rows = range(0, h, restart_rows) if restart_rows else [0]
        for n, r0 in enumerate(rows):
            r1 = min(h, r0 + restart_rows) if restart_rows else h
            vals, lens = _code_differences(diffs[r0:r1][..., group].reshape(-1), True)
            out += _pack(vals, lens)
            if restart_rows and r1 < h:
                out += bytes([0xFF, 0xD0 + n % 8])
    return out + b'\xff\xd9'


def encode_dc_only(dc: np.ndarray, precision: int = 8) -> bytes:
    """An extended sequential JPEG (SOF1) whose 8x8 blocks hold only a DC
    coefficient: ``dc`` (bh, bw[, C]) quantized DC values, every component
    at 1x1 sampling with ids 1, 2, ..., no Adobe marker, quantization table
    value 1 (16-bit entries at 12 bits)."""
    planes = dc[..., None] if dc.ndim == 2 else dc
    bh, bw, nc = planes.shape
    ids = list(range(1, nc + 1))
    out = _header(8 * bw, 8 * bh, ids, [0x11] * nc, 0xC1, precision, False, None)
    if precision == 8:
        out += _segment(0xDB, bytes([0]) + bytes([1] * 64))
    else:
        out += _segment(0xDB, bytes([0x10]) + struct.pack('>64H', *([1] * 64)))
    out += _dht(0, 0, _DCT_DC_BITS, _DCT_DC_VALS) + _dht(1, 0, _AC_BITS, _AC_VALS)
    out += _segment(0xDA, bytes([nc]) + b''.join(bytes([i, 0x00]) for i in ids)
                    + bytes([0, 63, 0]))
    flat = planes.reshape(-1, nc).astype(np.int64)
    diffs = np.diff(flat, axis=0, prepend=0)
    vals, lens = _code_differences(diffs.reshape(-1), False)
    # each block: its DC code, then EOB (code 0, one bit)
    vals = np.stack([vals, np.zeros_like(vals)], -1).reshape(-1)
    lens = np.stack([lens, np.ones_like(lens)], -1).reshape(-1)
    return out + _pack(vals, lens) + b'\xff\xd9'


def _element(group: int, elem: int, vr: str, data: bytes) -> bytes:
    if len(data) % 2:
        data += b'\x00' if vr in ('OB', 'UI') else b' '
    head = struct.pack('<HH', group, elem) + vr.encode()
    if vr in ('OB',):
        return head + b'\x00\x00' + struct.pack('<I', len(data)) + data
    return head + struct.pack('<H', len(data)) + data


def write_encapsulated_dicom(path: str, fragments_per_frame, rows: int, cols: int, spp: int,
                             ts: str, n_frames: Optional[int] = None) -> None:
    """A DICOM file (explicit VR little endian) in transfer syntax ``ts``
    whose pixel data is encapsulated: an empty basic offset table, then each
    frame's fragments. ``n_frames`` None leaves NumberOfFrames out (a
    single-frame image)."""
    meta = _element(0x0002, 0x0010, 'UI', ts.encode())
    body = b''
    if n_frames is not None:
        body += _element(0x0028, 0x0008, 'IS', str(n_frames).encode())
    body += _element(0x0028, 0x0002, 'US', struct.pack('<H', spp))
    body += _element(0x0028, 0x0004, 'CS', b'YBR_FULL_422' if spp == 3 else b'MONOCHROME2')
    body += _element(0x0028, 0x0010, 'US', struct.pack('<H', rows))
    body += _element(0x0028, 0x0011, 'US', struct.pack('<H', cols))
    body += _element(0x0028, 0x0100, 'US', struct.pack('<H', 8))
    px = (struct.pack('<HH', 0x7FE0, 0x0010) + b'OB\x00\x00' + struct.pack('<I', 0xFFFFFFFF)
          + struct.pack('<HHI', 0xFFFE, 0xE000, 0))
    for frame in fragments_per_frame:
        for frag in frame:
            frag = frag + b'\x00' * (len(frag) % 2)
            px += struct.pack('<HHI', 0xFFFE, 0xE000, len(frag)) + frag
    px += struct.pack('<HHI', 0xFFFE, 0xE0DD, 0)
    with open(path, 'wb') as f:
        f.write(b'\x00' * 128 + b'DICM' + meta + body + px)


# ------------------------------ byte patches --------------------------------

def markers(data: bytes):
    """(offset, marker) of every marker segment before the first scan's data
    and between scans, in order."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f'no marker at {pos}')
        marker = data[pos + 1]
        out.append((pos, marker))
        if marker == 0xD9:
            break
        (length,) = struct.unpack_from('>H', data, pos + 2)
        pos += 2 + length
        if marker == 0xDA:     # skip the entropy-coded data
            while not (data[pos] == 0xFF and data[pos + 1] not in (0x00,)
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
    return out


def set_frame_marker(data: bytes, sof: int) -> bytes:
    """The stream with its frame marker (SOFn) replaced by ``sof``."""
    for pos, marker in markers(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data[:pos + 1] + bytes([sof]) + data[pos + 2:]
    raise ValueError('no frame marker')


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    """The stream with its Adobe APP14 transform byte set to ``transform``."""
    for pos, marker in markers(data):
        if marker == 0xEE and data[pos + 4:pos + 9] == b'Adobe':
            return data[:pos + 15] + bytes([transform]) + data[pos + 16:]
    raise ValueError('no Adobe marker')


def first_scans(data: bytes, n: int) -> bytes:
    """The stream cut after its first ``n`` scans, with an EOI."""
    scans = [pos for pos, marker in markers(data) if marker == 0xDA]
    if n >= len(scans):
        return data
    # the segment after the n-th scan's data starts at the next marker
    after = [pos for pos, _m in markers(data) if pos > scans[n - 1]]
    return data[:after[0]] + b'\xff\xd9'
