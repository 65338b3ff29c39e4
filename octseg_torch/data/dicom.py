"""Minimal self-contained DICOM reader/writer for OCT pullbacks.

A copy of octseg/data/dicom.py (numpy and struct only; the port imports
nothing of octseg). It implements the subset OCT pullbacks need:

- read: explicit & implicit VR little endian; native (uncompressed) pixel
  data for uint8/uint16; encapsulated JPEG Baseline (1.2.840.10008.1.2.4.50)
  and JPEG Extended (.51) frames, decoded as octseg decodes them with
  ``cv2.imdecode(..., IMREAD_UNCHANGED)`` by the port's own decoder
  (data/jpeg.py); other encapsulated transfer syntaxes raise. The tag
  dictionary covers the fields the metadata extractor exports.
- write: explicit VR little endian, multi-frame 8-bit RGB or grayscale,
  uncompressed — used by tests and demo-data generation.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from octseg_torch.data.jpeg import ROADMAP_ITEM, decode_jpeg

EXPLICIT_LE = '1.2.840.10008.1.2.1'
IMPLICIT_LE = '1.2.840.10008.1.2'
JPEG_BASELINE = '1.2.840.10008.1.2.4.50'
JPEG_EXTENDED = '1.2.840.10008.1.2.4.51'

# Keyword -> (group, element, VR)
TAGS = {
    'TransferSyntaxUID': (0x0002, 0x0010, 'UI'),
    'StudyInstanceUID': (0x0020, 0x000D, 'UI'),
    'SeriesInstanceUID': (0x0020, 0x000E, 'UI'),
    'SOPInstanceUID': (0x0008, 0x0018, 'UI'),
    'SOPClassUID': (0x0008, 0x0016, 'UI'),
    'AcquisitionDate': (0x0008, 0x0022, 'DA'),
    'AcquisitionTime': (0x0008, 0x0032, 'TM'),
    'PatientName': (0x0010, 0x0010, 'PN'),
    'PatientSex': (0x0010, 0x0040, 'CS'),
    'BodyPartExamined': (0x0018, 0x0015, 'CS'),
    'PerformingPhysicianName': (0x0008, 0x1050, 'PN'),
    'InstitutionName': (0x0008, 0x0080, 'LO'),
    'Manufacturer': (0x0008, 0x0070, 'LO'),
    'Modality': (0x0008, 0x0060, 'CS'),
    'ImageType': (0x0008, 0x0008, 'CS'),
    'Rows': (0x0028, 0x0010, 'US'),
    'Columns': (0x0028, 0x0011, 'US'),
    'NumberOfFrames': (0x0028, 0x0008, 'IS'),
    'SamplesPerPixel': (0x0028, 0x0002, 'US'),
    'BitsAllocated': (0x0028, 0x0100, 'US'),
    'BitsStored': (0x0028, 0x0101, 'US'),
    'HighBit': (0x0028, 0x0102, 'US'),
    'PixelRepresentation': (0x0028, 0x0103, 'US'),
    'PhotometricInterpretation': (0x0028, 0x0004, 'CS'),
    'PlanarConfiguration': (0x0028, 0x0006, 'US'),
    'WindowCenter': (0x0028, 0x1050, 'DS'),
    'WindowWidth': (0x0028, 0x1051, 'DS'),
    'PixelData': (0x7FE0, 0x0010, 'OB'),
}
_TAG_TO_KEYWORD = {(g, e): kw for kw, (g, e, _vr) in TAGS.items()}

_SHORT_VRS = {
    'AE', 'AS', 'AT', 'CS', 'DA', 'DS', 'DT', 'FL', 'FD', 'IS', 'LO', 'LT',
    'PN', 'SH', 'SL', 'SS', 'ST', 'TM', 'UI', 'UL', 'US',
}
_STR_VRS = {'AE', 'AS', 'CS', 'DA', 'DS', 'DT', 'IS', 'LO', 'LT', 'PN', 'SH',
            'ST', 'TM', 'UI', 'UT'}


class DicomError(ValueError):
    pass


class Dataset:
    """Tag dictionary with pydicom-style keyword attribute access."""

    def __init__(self):
        self._elements: Dict[Tuple[int, int], Any] = {}

    def __contains__(self, keyword: str) -> bool:
        tag = TAGS.get(keyword)
        return tag is not None and (tag[0], tag[1]) in self._elements

    def __getattr__(self, keyword: str):
        if keyword.startswith('_'):
            raise AttributeError(keyword)
        tag = TAGS.get(keyword)
        if tag and (tag[0], tag[1]) in self._elements:
            return self._elements[(tag[0], tag[1])]
        raise AttributeError(keyword)

    def get(self, keyword: str, default=None):
        try:
            return getattr(self, keyword)
        except AttributeError:
            return default

    def set(self, keyword: str, value) -> None:
        g, e, _ = TAGS[keyword]
        self._elements[(g, e)] = value

    # --- pixel decoding -------------------------------------------------
    @property
    def pixel_array(self) -> np.ndarray:
        raw = self.get('PixelData')
        if raw is None:
            raise DicomError('No PixelData')
        rows = int(self.get('Rows'))
        cols = int(self.get('Columns'))
        spp = int(self.get('SamplesPerPixel', 1))
        frames = int(self.get('NumberOfFrames', 1))
        bits = int(self.get('BitsAllocated', 8))
        ts = self.get('TransferSyntaxUID', EXPLICIT_LE)

        if isinstance(raw, np.ndarray):  # zero-copy mmap view (uint8)
            dtype = np.uint8 if bits == 8 else np.uint16
            arr = raw.view(dtype) if dtype != np.uint8 else raw
            expected = frames * rows * cols * spp
            arr = arr[:expected]
            if spp > 1:
                planar = int(self.get('PlanarConfiguration', 0))
                if planar == 1:
                    arr = arr.reshape(frames, spp, rows, cols).transpose(0, 2, 3, 1)
                else:
                    arr = arr.reshape(frames, rows, cols, spp)
            else:
                arr = arr.reshape(frames, rows, cols)
            if frames == 1 and self.get('NumberOfFrames') is None:
                arr = arr[0]
            return arr  # non-contiguous views stay zero-copy
        if isinstance(raw, list):  # encapsulated fragments
            arr = self._decode_fragments(raw, frames, ts)
            if frames == 1 and self.get('NumberOfFrames') is None:
                arr = arr[0]
            return arr
        dtype = np.uint8 if bits == 8 else np.uint16
        arr = np.frombuffer(raw, dtype=dtype)
        expected = frames * rows * cols * spp
        arr = arr[:expected]
        if spp > 1:
            planar = int(self.get('PlanarConfiguration', 0))
            if planar == 1:
                arr = arr.reshape(frames, spp, rows, cols).transpose(0, 2, 3, 1)
            else:
                arr = arr.reshape(frames, rows, cols, spp)
        else:
            arr = arr.reshape(frames, rows, cols)
        if frames == 1 and arr.shape[0] == 1 and self.get('NumberOfFrames') is None:
            arr = arr[0]
        return np.ascontiguousarray(arr)

    @staticmethod
    def _decode_fragments(raw: List[bytes], frames: int, ts: str) -> np.ndarray:
        """JPEG frames -> (frames, H, W, 3) RGB or (frames, H, W) uint8, as
        octseg's cv2.imdecode path: one frame split into several fragments
        is joined; any other mismatch of fragments and frames raises."""
        if ts not in (JPEG_BASELINE, JPEG_EXTENDED):
            raise NotImplementedError(
                f'encapsulated pixel data in transfer syntax {ts} is not decoded: '
                f'octseg_torch decodes JPEG Baseline and Extended frames ({ROADMAP_ITEM})')
        if len(raw) != frames:
            if frames != 1:
                raise DicomError(f'{len(raw)} pixel-data fragments for {frames} frames '
                                 f'and no usable offset table')
            raw = [b''.join(raw)]
        # the entropy decoder runs outside the interpreter lock (ctypes), and
        # so does most of numpy's share
        with ThreadPoolExecutor(min(8, len(raw), os.cpu_count() or 1)) as pool:
            return np.stack(list(pool.map(decode_jpeg, raw)))


def _skip_undefined_sequence(buf, pos: int, explicit: bool) -> int:
    """Skip an undefined-length SQ value, pos just past its element header.

    Items with a defined length are skipped wholesale; undefined-length
    items contain a nested DATASET whose elements must be walked with the
    file's real VR encoding — reading their bytes as bare (group, elem,
    len32) item headers (the old approach) parses explicit-VR bytes as a
    length and desyncs the stream (losing PixelData on files with the
    standard per-frame functional-group sequences)."""
    while pos + 8 <= len(buf):
        g2, e2 = struct.unpack_from('<HH', buf, pos)
        (ilen,) = struct.unpack_from('<I', buf, pos + 4)
        pos += 8
        if (g2, e2) == (0xFFFE, 0xE0DD):  # sequence delimitation
            return pos
        if (g2, e2) != (0xFFFE, 0xE000):
            raise DicomError('Malformed sequence (expected item header)')
        if ilen != 0xFFFFFFFF:
            pos += ilen
        else:
            pos = _skip_undefined_item(buf, pos, explicit)
    return pos


def _skip_undefined_item(buf, pos: int, explicit: bool) -> int:
    """Skip an undefined-length item's dataset, up to (FFFE,E00D)."""
    while pos + 8 <= len(buf):
        g2, e2 = struct.unpack_from('<HH', buf, pos)
        if (g2, e2) == (0xFFFE, 0xE00D):  # item delimitation (len 0)
            return pos + 8
        _g, _e, _vr, length, pos = _read_element(buf, pos, explicit=explicit)
        if length == 0xFFFFFFFF:  # nested undefined-length SQ
            pos = _skip_undefined_sequence(buf, pos, explicit)
        else:
            pos += length
    return pos


def _read_element(buf: bytes, pos: int, explicit: bool):
    group, elem = struct.unpack_from('<HH', buf, pos)
    pos += 4
    if explicit and group != 0xFFFE:
        vr = buf[pos:pos + 2].decode('ascii', 'replace')
        pos += 2
        if vr in _SHORT_VRS:
            (length,) = struct.unpack_from('<H', buf, pos)
            pos += 2
        else:
            pos += 2  # reserved
            (length,) = struct.unpack_from('<I', buf, pos)
            pos += 4
    else:
        vr = None
        (length,) = struct.unpack_from('<I', buf, pos)
        pos += 4
    return group, elem, vr, length, pos


def _parse_value(vr: Optional[str], data: bytes):
    if vr in ('US',):
        n = len(data) // 2
        vals = struct.unpack('<' + 'H' * n, data)
        return vals[0] if n == 1 else list(vals)
    if vr in ('UL',):
        n = len(data) // 4
        vals = struct.unpack('<' + 'I' * n, data)
        return vals[0] if n == 1 else list(vals)
    if vr is None or vr in _STR_VRS:
        try:
            s = data.decode('ascii').rstrip('\x00 ').strip()
        except UnicodeDecodeError:
            return data
        if vr == 'IS' and s:
            return s
        return s
    return data


def dcmread(path: str, use_mmap: bool = True) -> Dataset:
    """Parse a DICOM file. With use_mmap (default) the pixel data is a
    zero-copy view into a memory map — decoding a multi-GB pullback costs
    header parsing only, and bytes stream from the page cache on upload."""
    if use_mmap:
        import mmap as _mmap

        f = open(path, 'rb')
        try:
            buf = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ValueError, OSError):
            buf = f.read()
            f.close()
    else:
        with open(path, 'rb') as f:
            buf = f.read()
    if len(buf) < 132 or buf[128:132] != b'DICM':
        raise DicomError(f'{path}: not a DICOM file (missing DICM magic)')
    ds = Dataset()
    pos = 132

    # file meta group: always explicit VR LE
    ts = EXPLICIT_LE
    while pos + 8 <= len(buf):
        (peek_group,) = struct.unpack_from('<H', buf, pos)
        if peek_group != 0x0002:
            break
        group, elem, vr, length, pos = _read_element(buf, pos, explicit=True)
        value = _parse_value(vr, buf[pos:pos + length])
        pos += length
        if (group, elem) == (0x0002, 0x0010):
            ts = value
        ds._elements[(group, elem)] = value
    explicit = ts != IMPLICIT_LE
    encapsulated = ts not in (EXPLICIT_LE, IMPLICIT_LE)

    while pos + 8 <= len(buf):
        group, elem, vr, length, pos = _read_element(buf, pos, explicit=explicit)
        if (group, elem) == (0x7FE0, 0x0010) and length == 0xFFFFFFFF:
            # encapsulated pixel data: basic offset table + fragments.
            # A frame MAY span several fragments (PS3.5 A.4) — record each
            # fragment's item-header offset from the post-BOT anchor and
            # regroup by the BOT when it is present.
            fragments: List[bytes] = []
            frag_off: List[int] = []
            bot: List[int] = []
            anchor = None
            first = True
            while pos + 8 <= len(buf):
                g2, e2 = struct.unpack_from('<HH', buf, pos)
                (ilen,) = struct.unpack_from('<I', buf, pos + 4)
                header_pos = pos
                pos += 8
                if (g2, e2) == (0xFFFE, 0xE0DD):  # sequence delimiter
                    break
                if (g2, e2) != (0xFFFE, 0xE000):
                    raise DicomError('Malformed encapsulated pixel data')
                if first:
                    first = False  # basic offset table
                    bot = list(struct.unpack_from(f'<{ilen // 4}I', buf, pos))
                    anchor = pos + ilen
                else:
                    fragments.append(bytes(buf[pos:pos + ilen]))
                    frag_off.append(header_pos - anchor)
                pos += ilen
            if len(bot) > 1 and len(fragments) > len(bot):
                # multi-fragment frames with an offset table: each BOT entry
                # is the offset of a frame's first fragment item header
                groups: List[bytes] = []
                bounds = bot[1:] + [float('inf')]
                for k, off in enumerate(bot):
                    parts = [f for f, fo in zip(fragments, frag_off)
                             if off <= fo < bounds[k]]
                    groups.append(b''.join(parts))
                fragments = groups
            ds._elements[(group, elem)] = fragments
            continue
        if length == 0xFFFFFFFF:  # undefined-length sequence: skip it
            pos = _skip_undefined_sequence(buf, pos, explicit)
            continue
        if (group, elem) == (0x7FE0, 0x0010):
            # zero-copy view into the (possibly mmapped) file buffer
            ds._elements[(group, elem)] = np.frombuffer(
                buf, np.uint8, count=length, offset=pos
            )
            pos += length
            continue
        data = buf[pos:pos + length]
        pos += length
        if (group, elem) in _TAG_TO_KEYWORD or group in (0x0008, 0x0010, 0x0018,
                                                         0x0020, 0x0028):
            kw_vr = vr
            if not explicit:
                known = {(g, e): v for _k, (g, e, v) in TAGS.items()}
                kw_vr = known.get((group, elem))
            ds._elements[(group, elem)] = _parse_value(kw_vr, data)
    if (0x7FE0, 0x0010) in ds._elements and not isinstance(
        ds._elements[(0x7FE0, 0x0010)], (list, bytes, np.ndarray)
    ):
        ds._elements[(0x7FE0, 0x0010)] = bytes(ds._elements[(0x7FE0, 0x0010)])
    return ds


def _encode_element(group: int, elem: int, vr: str, data: bytes) -> bytes:
    if len(data) % 2:
        data += b'\x00' if vr not in _STR_VRS else b' '
    head = struct.pack('<HH', group, elem)
    if vr in _SHORT_VRS:
        return head + vr.encode() + struct.pack('<H', len(data)) + data
    return head + vr.encode() + b'\x00\x00' + struct.pack('<I', len(data)) + data


def dcmwrite(path: str, frames: np.ndarray, tags: Optional[Dict[str, Any]] = None) -> None:
    """Write a multi-frame 8-bit DICOM (explicit VR LE, uncompressed).

    frames: (N, H, W, 3) RGB or (N, H, W) grayscale uint8.
    """
    frames = np.asarray(frames, dtype=np.uint8)
    n, h, w = frames.shape[:3]
    spp = frames.shape[3] if frames.ndim == 4 else 1

    values: Dict[str, Any] = {
        'SOPClassUID': '1.2.840.10008.5.1.4.1.1.77.1.5.4',
        'SOPInstanceUID': '1.2.826.0.1.3680043.8.498.1',
        'StudyInstanceUID': '1.2.826.0.1.3680043.8.498.2',
        'SeriesInstanceUID': '1.2.826.0.1.3680043.8.498.3',
        'Modality': 'OCT',
        'Rows': h,
        'Columns': w,
        'NumberOfFrames': str(n),
        'SamplesPerPixel': spp,
        'PhotometricInterpretation': 'RGB' if spp == 3 else 'MONOCHROME2',
        'PlanarConfiguration': 0,
        'BitsAllocated': 8,
        'BitsStored': 8,
        'HighBit': 7,
        'PixelRepresentation': 0,
    }
    if spp == 1:
        values.pop('PlanarConfiguration')
    values.update(tags or {})

    meta = b''
    meta += _encode_element(0x0002, 0x0010, 'UI', EXPLICIT_LE.encode())
    meta += _encode_element(0x0002, 0x0002, 'UI', values['SOPClassUID'].encode())
    meta += _encode_element(0x0002, 0x0003, 'UI', values['SOPInstanceUID'].encode())
    group_len = _encode_element(0x0002, 0x0000, 'UL', struct.pack('<I', len(meta)))

    body = b''
    for kw in sorted(values, key=lambda k: TAGS[k][:2]):
        g, e, vr = TAGS[kw]
        v = values[kw]
        if vr == 'US':
            data = struct.pack('<H', int(v))
        elif vr in _STR_VRS:
            data = str(v).encode()
        else:
            data = v if isinstance(v, bytes) else str(v).encode()
        body += _encode_element(g, e, vr, data)
    body += _encode_element(0x7FE0, 0x0010, 'OB', frames.tobytes())

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(b'\x00' * 128 + b'DICM')
        f.write(group_len + meta)
        f.write(body)
