"""The training data loader in host C++ (the port of
octseg/train/native_loader.py).

``NativeLoader`` is PrefetchLoader's interface over ``csrc/dataloader.cc``:
PNG decode, LZW mask-TIFF decode, the resizes, channel selection and batch
collation run on a C++ thread pool, and Python receives NHWC float32 numpy
batches. As in octseg: epoch ``e`` of ``__iter__`` shuffles with
``std::mt19937(seed + e)`` and ``std::shuffle``; the first epoch's batches
start decoding when the loader is made; the last partial batch is dropped;
a batch that fails to decode raises IOError.

Unlike octseg's, batches come in index order whatever the number of
workers (see dataloader.cc), so a run equals a rerun. A failed g++ build or
a missing zlib raises: nothing falls back to the Python loader.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from octseg_torch.ops.kernels import _build


def load_library() -> ctypes.CDLL:
    """``csrc/dataloader.cc`` + ``lzw.cc``, built and typed."""
    lib = _build.load_host('dataloader')
    if not getattr(lib, '_configured', False):
        lib.octseg_loader_create.restype = ctypes.c_void_p
        lib.octseg_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint,
        ]
        lib.octseg_loader_next.restype = ctypes.c_int
        lib.octseg_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.octseg_loader_reset.restype = None
        lib.octseg_loader_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint]
        lib.octseg_loader_destroy.restype = None
        lib.octseg_loader_destroy.argtypes = [ctypes.c_void_p]
        lib._configured = True
    return lib


class NativeLoader:
    """PrefetchLoader-compatible iterator over a verified OCTDataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, num_workers: Optional[int] = None):
        if not drop_last:
            raise NotImplementedError('NativeLoader always drops the last partial batch')
        self._lib = load_library()
        self.dataset = dataset
        self.batch_size = batch_size
        self.input_size = dataset.input_size
        self.n_classes = len(dataset.class_ids)
        self.epoch = 0

        n = len(dataset)
        img_arr = (ctypes.c_char_p * n)(*[p.encode() for p in dataset.img_paths])
        mask_arr = (ctypes.c_char_p * n)(*[p.encode() for p in dataset.mask_paths])
        channels = (ctypes.c_int * self.n_classes)(*[cid - 1 for cid in dataset.class_ids])
        workers = num_workers or max((os.cpu_count() or 2) - 1, 1)
        self._handle = self._lib.octseg_loader_create(
            img_arr, mask_arr, n, self.input_size, self.n_classes, channels,
            batch_size, workers, int(shuffle), seed)
        # the C++ side keeps copies of the paths; channels too
        self._keepalive = (img_arr, mask_arr, channels)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.epoch > 0:
            self._lib.octseg_loader_reset(self._handle, self.epoch)
        self.epoch += 1
        s = self.input_size
        while True:
            imgs = np.empty((self.batch_size, s, s, 3), np.float32)
            masks = np.empty((self.batch_size, s, s, self.n_classes), np.float32)
            got = self._lib.octseg_loader_next(
                self._handle,
                imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                masks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if got == 0:
                return
            if got < 0:
                raise IOError('native loader: decode error in batch')
            yield imgs, masks

    def __del__(self):
        if getattr(self, '_handle', None):
            self._lib.octseg_loader_destroy(self._handle)
            self._handle = None
