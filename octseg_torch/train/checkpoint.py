"""weights.ckpt in the flax msgpack layout, read and written without flax.

The port of the weights half of octseg/train/checkpoint.py. A model dir is
``config.json`` + ``weights.ckpt``; the checkpoint is one msgpack map
``{'params': {...}, 'batch_stats': {...}}`` of nested string-keyed maps whose
leaves are numpy arrays, encoded as flax's ``serialization.msgpack_serialize``
encodes them:

- ext type 1: an ndarray, payload = msgpack ``[shape, dtype name, C-order
  bytes]`` (flax ``_ndarray_to_bytes``);
- ext type 3: a numpy scalar, the same payload for a 0-d array;
- on reading, flax's chunked-array maps (``__msgpack_chunked_array__``),
  which flax writes for arrays above 2**30 bytes (no leaf of the ported
  models comes near that, so the writer does not chunk).

The msgpack codec below covers what such a file holds (maps, str, bin, ints,
floats, bool, nil, arrays, ext) and picks the same encodings as
msgpack-python's packer, so a tree written here is byte-identical to flax's.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = '__msgpack_chunked_array__'


# ------------------------------- encoder ---------------------------------

def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack('B', v))
    elif -0x20 <= v < 0:
        out.append(struct.pack('b', v))
    elif v >= 0:
        for code, fmt, limit in ((0xcc, '>B', 0xff), (0xcd, '>H', 0xffff),
                                 (0xce, '>I', 0xffffffff),
                                 (0xcf, '>Q', 0xffffffffffffffff)):
            if v <= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f'int {v} too large for msgpack')
    else:
        for code, fmt, limit in ((0xd0, '>b', -0x80), (0xd1, '>h', -0x8000),
                                 (0xd2, '>i', -0x80000000),
                                 (0xd3, '>q', -0x8000000000000000)):
            if v >= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f'int {v} too small for msgpack')


def _pack_len(n: int, fix_base: int, fix_max: int, codes, out: list) -> None:
    """Header of a str/bin/array/map/ext of length n: fix form when given
    (fix_base, fix_max), else the 8/16/32-bit length forms in ``codes``
    (None for a width the type lacks)."""
    if fix_base is not None and n <= fix_max:
        out.append(bytes([fix_base | n]))
        return
    for code, fmt, limit in zip(codes, ('>B', '>H', '>I'), (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f'msgpack object of length {n} is too large')


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n]]) + struct.pack('b', code))
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
        out.append(struct.pack('b', code))
    out.append(data)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes are not serializable')
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes('C')))


def _pack(obj: Any, out: list) -> None:
    # exact-type dispatch, as msgpack-python's strict_types=True packer
    t = type(obj)
    if obj is None:
        out.append(b'\xc0')
    elif t is bool:
        out.append(b'\xc3' if obj else b'\xc2')
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(b'\xcb' + struct.pack('>d', obj))
    elif t is str:
        data = obj.encode('utf-8')
        _pack_len(len(data), 0xa0, 31, (0xd9, 0xda, 0xdb), out)
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xc4, 0xc5, 0xc6), out)
        out.append(data)
    elif t in (list, tuple):
        _pack_len(len(obj), 0x90, 15, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 15, (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f'cannot msgpack-encode {t.__name__}')


def packb(obj: Any) -> bytes:
    out: list = []
    _pack(obj, out)
    return b''.join(out)


# ------------------------------- decoder ---------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError('truncated msgpack data')
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def _str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode('utf-8')

    def _ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f'unsupported msgpack ext type {code}')

    def read(self) -> Any:
        b = self.unpack('B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q',
                0xca: '>f', 0xcb: '>d'}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xd9: '>B', 0xda: '>H',
                0xdb: '>I', 0xdc: '>H', 0xdd: '>I', 0xde: '>H', 0xdf: '>I',
                0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}
        if b in lens:
            n = self.unpack(lens[b])
            if b in (0xc4, 0xc5, 0xc6):
                return bytes(self.take(n))
            if b in (0xd9, 0xda, 0xdb):
                return self._str(n)
            if b in (0xdc, 0xdd):
                return [self.read() for _ in range(n)]
            if b in (0xde, 0xdf):
                return self._map(n)
            return self._ext(self.unpack('b'), n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self._ext(self.unpack('b'), fixext[b])
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw=raw)
    value = r.read()
    if r.pos != len(r.buf):
        raise ValueError('extra bytes after the msgpack object')
    return value


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    if dtype_name == b'bfloat16':
        raise ValueError('bfloat16 leaves are not supported by the port')
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order='C')


# ------------------------------ tree helpers -------------------------------

def _sorted_keys(tree: Any) -> Any:
    # flax maps the tree with jax.tree_util before packing, which orders
    # dict keys
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
            chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


# --------------------------------- API -----------------------------------

def serialize(tree: Dict[str, Any]) -> bytes:
    """flax ``msgpack_serialize`` of a tree of dicts with numpy leaves."""
    return packb(_sorted_keys(tree))


def restore(data: bytes) -> Dict[str, Any]:
    """flax ``msgpack_restore``: nested dicts with numpy-array leaves."""
    return _unchunk_leaves(unpackb(data))


def save_weights(path: str, params: Dict[str, Any],
                 batch_stats: Dict[str, Any]) -> None:
    """Write ``{'params', 'batch_stats'}`` (numpy leaves) to ``path``
    atomically, in the layout octseg.train.checkpoint.load_weights reads."""
    data = serialize({'params': params, 'batch_stats': batch_stats})
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, path)


def load_weights(path: str) -> Dict[str, Any]:
    with open(path, 'rb') as f:
        return restore(f.read())


def initialize_model_dir(model_dir: str, classes, arch: str = 'Unet',
                         encoder: str = 'resnet18', input_size: int = 512,
                         seed: int = 0) -> str:
    """Create a model dir (weights.ckpt + config.json, the reference layout)
    with random weights drawn from ``torch.Generator().manual_seed(seed)``:
    conv weights N(0, 1/fan_in), conv biases 0, BatchNorm at its identity
    (scale 1, bias 0, mean 0, var 1), as flax initializes them. For tests and
    smoke runs; training writes real weights."""
    import json

    import torch

    from octseg_torch.models import create_model
    from octseg_torch.models.convert import state_dict_to_variables

    os.makedirs(model_dir, exist_ok=True)
    model = create_model(arch, encoder, classes=len(classes))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.normal_(0.0, (1.0 / mod.weight[0].numel()) ** 0.5,
                                   generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = state_dict_to_variables(sd, arch, encoder)
    save_weights(os.path.join(model_dir, 'weights.ckpt'),
                 variables['params'], variables['batch_stats'])
    with open(os.path.join(model_dir, 'config.json'), 'w') as f:
        json.dump({
            'model_name': f'{arch}_{encoder}',
            'architecture': arch,
            'encoder': encoder,
            'input_size': input_size,
            'classes': list(classes),
            'batch_size': 4,
            'optimizer': 'Adam',
            'lr': 1e-4,
            'normalize': True,  # octseg-trained: inference matches training
        }, f, indent=2)
    return model_dir
