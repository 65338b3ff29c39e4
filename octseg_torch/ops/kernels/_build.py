"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built with nvcc for sm_90a) or
``csrc/<name>.cc`` (host C++, built with g++) exposes a plain C interface.
At first use it is compiled into ``octseg_torch/_build/<name>-<hash>.so``,
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as built. Nothing here runs at import time.
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
GXX_FLAGS = ('-std=c++17', '-O2', '-shared', '-fPIC')

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
                           'entropy decoder) is built with it')
    return gxx


def library_path(source: str, flags: Sequence[str]) -> str:
    """``_build/<name>-<hash>.so`` for ``csrc/<source>`` built with ``flags``."""
    with open(os.path.join(CSRC_DIR, source), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f'{os.path.splitext(source)[0]}-{digest[:16]}.so')


def _load(source: str, compiler: str, flags: Sequence[str]) -> ctypes.CDLL:
    """Safe to call from several threads at once: one source builds once,
    and several sources build in parallel (the compiler runs outside the
    GIL)."""
    with _locks_lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        return _load_locked(source, compiler, flags)


def _load_locked(source: str, compiler: str, flags: Sequence[str]) -> ctypes.CDLL:
    if source not in _libs:
        out = library_path(source, flags)
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{out}.{os.getpid()}.tmp'
            proc = subprocess.run([compiler, *flags, '-o', tmp, os.path.join(CSRC_DIR, source)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'{os.path.basename(compiler)} failed for csrc/{source}:\n'
                                   f'{proc.stdout}')
            os.replace(tmp, out)   # atomic: a concurrent build sees a whole file
        _libs[source] = ctypes.CDLL(out)
    return _libs[source]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of the CUDA source ``csrc/<name>.cu``, built with
    nvcc first if needed."""
    return _load(f'{name}.cu', find_nvcc(), NVCC_FLAGS)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host C++ source ``csrc/<name>.cc``, built
    with g++ first if needed."""
    return _load(f'{name}.cc', find_gxx(), GXX_FLAGS)
