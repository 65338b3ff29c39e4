"""octseg_torch's C++ training loader against octseg's and against the
port's Python loader, on the CPU.

- Against octseg's ``NativeLoader`` with one worker (octseg's order is
  racy with more; see below), shuffled over three epochs: masks equal, and
  images within IMG_FMA_ATOL. octseg builds with ``-O3 -march=native``,
  under which g++ contracts the bilinear sums into FMAs on this host; the
  port builds with ``-ffp-contract=off``. At 80 -> 48 px (weights that are
  not short binary fractions) the two differ by one float32 ulp of a value
  in 128..256, 1.53e-5; at 80 -> 64 px they are bit-exact.
- Against the port's Python loader (``train/data.py``, cv2's fixed-point
  INTER_LINEAR) in index order: masks equal, images within 1.0, the bound
  octseg's own test holds its loader to.
- Batches in index order: 20 runs with 7 workers give the one-worker
  sequence. Control: octseg's loader, 7 workers, goes out of order at least
  once in 20 runs.
- LZW: the C++ codec (``csrc/lzw.cc``) against the Python one, byte for byte.
- A truncated PNG and a 16-bit PNG give IOError in both packages.
- A resumed epoch (``loader.epoch = e``) draws what epoch ``e`` of an
  uninterrupted loader does.
- ``train_model`` with ``native_loader`` ``auto`` raises, naming
  ``native_loader=false``, when the library cannot be built (zlib missing).

octseg's library is built here from octseg's sources with octseg's flags
into a temporary directory, so that this file never races octseg's own
tests for octseg/native/_build.
"""

import ctypes
import os
import subprocess

import cv2
import numpy as np
import pytest

import octseg.native as jax_native
from octseg.data import tiffio as jax_tiffio
from octseg.train import native_loader as jax_native_loader
from octseg.train.data import OCTDataset as JaxOCTDataset
from octseg_torch.core.config import Config
from octseg_torch.data import tiffio
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.ops.kernels import _build
from octseg_torch.train.data import OCTDataset, PrefetchLoader
from octseg_torch.train.native_loader import NativeLoader
from octseg_torch.train.train import train_model

CLASSES = ['Lumen', 'Fibrous cap']
SIZE = 48
IMG_FMA_ATOL = 1e-4


@pytest.fixture(scope='module')
def jax_loader(tmp_path_factory):
    """octseg's NativeLoader class, bound to octseg's library built here."""
    out = str(tmp_path_factory.mktemp('octseg_native') / 'libdataloader.so')
    src_dir = os.path.dirname(jax_native.__file__)
    subprocess.run(['g++', *jax_native._CXXFLAGS, '-o', out,
                    *(os.path.join(src_dir, s) for s in jax_native._SOURCES['dataloader']),
                    *jax_native._EXTRA_LINK['dataloader']], check=True)
    lib = ctypes.CDLL(out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_loader, 'load_library', lambda name: lib)
        yield jax_native_loader.NativeLoader


@pytest.fixture(scope='module')
def fold(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('native_loader') / 'fold')
    make_synth_fold(path, n_train=16, n_test=2, size=80, seed=3)
    return path


def _datasets(split_dir, size=SIZE):
    ours = OCTDataset(split_dir, CLASSES, size)
    theirs = JaxOCTDataset(split_dir, CLASSES, input_size=size)
    assert list(ours.img_paths) == list(theirs.img_paths)
    return ours, theirs


@pytest.mark.parametrize('size', [SIZE, 64])
def test_matches_octsegs_loader_with_one_worker(fold, jax_loader, size):
    ours, theirs = _datasets(f'{fold}/train', size)
    a = NativeLoader(ours, 4, shuffle=True, seed=5, num_workers=1)
    b = jax_loader(theirs, 4, shuffle=True, seed=5, num_workers=1)
    assert len(a) == len(b) == 4
    worst = 0.0
    for _epoch in range(3):
        got, want = list(a), list(b)
        assert len(got) == len(want) == 4
        for (gi, gm), (wi, wm) in zip(got, want):
            np.testing.assert_array_equal(gm, wm)
            worst = max(worst, float(np.abs(gi - wi).max()))
    assert worst <= IMG_FMA_ATOL
    if size == 64:   # 80 -> 64: every weight a short binary fraction
        assert worst == 0.0


def test_matches_the_python_loader(fold):
    ds = OCTDataset(f'{fold}/train', CLASSES, SIZE)
    batches = list(NativeLoader(ds, 4, shuffle=False, num_workers=3))
    python = list(PrefetchLoader(ds, 4, shuffle=False, drop_last=True, num_workers=2))
    assert len(batches) == len(python) == 4
    for (gi, gm), (wi, wm) in zip(batches, python):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1.0)


def test_batches_come_in_index_order_for_any_worker_count(fold, jax_loader):
    ours, theirs = _datasets(f'{fold}/train')

    def sequence(loader):
        return [float(imgs.sum()) for imgs, _masks in loader]

    want = sequence(NativeLoader(ours, 1, shuffle=False, num_workers=1))
    for _run in range(20):
        assert sequence(NativeLoader(ours, 1, shuffle=False, num_workers=7)) == want
    # control: octseg's loader queues batches as they complete
    jax_want = sequence(jax_loader(theirs, 1, shuffle=False, num_workers=1))
    runs = [sequence(jax_loader(theirs, 1, shuffle=False, num_workers=7)) for _ in range(20)]
    assert all(sorted(r) == sorted(jax_want) for r in runs)
    assert any(r != jax_want for r in runs)


@pytest.mark.parametrize('kind', ['empty', 'one', 'few-symbols-70000', 'random-5000',
                                  'runs-200000'])
def test_lzw_codec_in_cpp_equals_python(kind):
    rng = np.random.default_rng(len(kind))
    data = {'empty': b'', 'one': b'\x07',
            'few-symbols-70000': rng.integers(0, 5, 70000, dtype=np.uint8).tobytes(),
            'random-5000': rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
            'runs-200000': np.repeat(rng.integers(0, 3, 400, dtype=np.uint8),
                                     500).tobytes()}[kind]
    encoded = tiffio.lzw_encode(data)
    assert encoded == tiffio._lzw_encode(data) == jax_tiffio._lzw_encode(data)
    assert tiffio.lzw_decode(encoded, len(data)) == tiffio._lzw_decode(encoded) == data


@pytest.mark.parametrize('fault', ['truncated', '16-bit'])
def test_decode_errors_raise_in_both_packages(tmp_path, jax_loader, fault):
    root = str(tmp_path / 'fold')
    make_synth_fold(root, n_train=4, n_test=1, size=48, seed=2)
    victim = f'{root}/train/img/train_0002.png'
    if fault == 'truncated':
        with open(victim, 'rb') as f:
            blob = f.read()
        with open(victim, 'wb') as f:
            f.write(blob[:len(blob) // 2])
    else:
        img = cv2.imread(victim)
        assert cv2.imwrite(victim, img.astype(np.uint16) * 257)
    ours, theirs = _datasets(f'{root}/train', 48)
    with pytest.raises(IOError):
        list(NativeLoader(ours, 4, shuffle=False, num_workers=2))
    with pytest.raises(IOError):
        list(jax_loader(theirs, 4, shuffle=False, num_workers=2))


def test_a_resumed_epoch_draws_what_an_uninterrupted_one_does(fold):
    ds = OCTDataset(f'{fold}/train', CLASSES, SIZE)
    loader = NativeLoader(ds, 4, shuffle=True, seed=9, num_workers=2)
    epochs = [list(loader) for _ in range(3)]
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(epochs[0], epochs[1]))
    resumed = NativeLoader(ds, 4, shuffle=True, seed=9, num_workers=2)
    resumed.epoch = 2
    got = list(resumed)
    assert len(got) == len(epochs[2]) == 4
    for (gi, gm), (wi, wm) in zip(got, epochs[2]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def test_a_failed_build_raises_and_never_falls_back(fold, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, '_libs', {})
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, 'HOST_LINK', {'dataloader': ('-l:libz_absent.so.1',
                                                             '-pthread')})
    cfg = Config(data_dir=fold, save_dir=str(tmp_path / 'models'), classes=['Lumen'],
                 architecture='Unet', encoder='resnet18', optimizer='Adam', lr=1e-3,
                 input_size=32, batch_size=4, epochs=1, use_augmentation=False, seed=1,
                 model_name='m', native_loader='auto')
    with pytest.raises(RuntimeError, match='native_loader=false') as info:
        train_model(cfg, device='cpu')
    assert 'libz_absent.so.1' in str(info.value)
