"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built with nvcc for sm_90a) or
``csrc/<name>.cc`` (host C++, built with g++; the training loader links
``lzw.cc`` beside it, and zlib) exposes a plain C interface. At first use it
is compiled into ``octseg_torch/_build/<name>-<hash>.so``, keyed by a hash
of every source and flag, so an edited source is rebuilt and an unchanged
one is loaded as built. Nothing here runs at import time.

Host C++ is built with ``-ffp-contract=off``: in C++, g++ contracts
``a * b + c`` into an FMA by default wherever the CPU has one, which would
make the loader's bilinear resize depend on the machine that built it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
GXX_FLAGS = ('-std=c++17', '-O2', '-ffp-contract=off', '-shared', '-fPIC')
# host libraries built from several sources, and what they link (after the
# sources, as --as-needed requires); zlib by its runtime name, so that no
# development package is needed
HOST_SOURCES = {'dataloader': ('dataloader.cc', 'lzw.cc')}
HOST_LINK = {'dataloader': ('-l:libz.so.1', '-pthread')}

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels of octseg_torch are built with it')


def find_gxx() -> str:
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; octseg_torch's host C++ (the JPEG "
                           'entropy decoder, the contour tracer, the training loader) is '
                           'built with it')
    return gxx


def library_path(name: str, sources: Sequence[str], flags: Sequence[str]) -> str:
    """``_build/<name>-<hash>.so`` for ``csrc/<sources>`` built with ``flags``."""
    digest = hashlib.sha256(' '.join(flags).encode())
    for source in sources:
        with open(os.path.join(CSRC_DIR, source), 'rb') as f:
            digest.update(source.encode() + b'\0' + f.read())
    return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def _load(name: str, sources: Sequence[str], compiler: str, flags: Sequence[str],
          link: Sequence[str] = ()) -> ctypes.CDLL:
    """Safe to call from several threads at once: one library builds once,
    and several libraries build in parallel (the compiler runs outside the
    GIL)."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_build(name, sources, compiler, flags, link))
        return _libs[name]


def _build(name: str, sources: Sequence[str], compiler: str, flags: Sequence[str],
           link: Sequence[str]) -> str:
    out = library_path(name, sources, (*flags, *link))
    if not os.path.isfile(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        proc = subprocess.run([compiler, *flags, '-o', tmp,
                               *(os.path.join(CSRC_DIR, s) for s in sources), *link],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'{os.path.basename(compiler)} failed for '
                               f'{" + ".join("csrc/" + s for s in sources)}'
                               f'{" linking " + " ".join(link) if link else ""}:\n'
                               f'{proc.stdout}')
        os.replace(tmp, out)   # atomic: a concurrent build sees a whole file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of the CUDA source ``csrc/<name>.cu``, built with
    nvcc first if needed."""
    return _load(name, (f'{name}.cu',), find_nvcc(), NVCC_FLAGS)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host C++ source ``csrc/<name>.cc`` (with
    the further sources and link flags HOST_SOURCES and HOST_LINK give it),
    built with g++ first if needed."""
    return _load(name, HOST_SOURCES.get(name, (f'{name}.cc',)), find_gxx(), GXX_FLAGS,
                 HOST_LINK.get(name, ()))
