"""Build the port's CUDA sources with plain nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for sm_90a into ``octseg_torch/_build/<name>-<hash>.so``, keyed by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as built. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels of octseg_torch are built with it')


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f'{name}.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f'{name}-{digest[:16]}.so')


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    Safe to call from several threads at once, one source each: nvcc runs
    outside the GIL, so the sources then build in parallel."""
    if name not in _libs:
        out = library_path(name)
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{out}.{os.getpid()}.{name}.tmp'
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, '-o', tmp,
                                   os.path.join(CSRC_DIR, f'{name}.cu')],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for csrc/{name}.cu:\n{proc.stdout}')
            os.replace(tmp, out)   # atomic: a concurrent build sees a whole file
        _libs[name] = ctypes.CDLL(out)
    return _libs[name]
