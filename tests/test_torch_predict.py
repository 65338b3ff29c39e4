"""The DICOM predict path of octseg_torch against the JAX package's.

Both entry points run the pullback of tests/test_infer.py (5 grayscale
64x64 frames, 4 classes, 48x48 output) through the same model dirs; the
PNGs are decoded with PIL and compared. Masks may differ only where the JAX
probability lies within 1e-4 of 0.5 (tests/test_torch_engine.py's rule),
overlays only within the reach of the postprocess (close 2 + ring 3 +
blur 2 pixels) of such a pixel.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from octseg.core.config import Config as JaxConfig
from octseg.data import dicom as jax_dicom
from octseg.infer import predict as jax_predict
from octseg_torch.core.config import Config
from octseg_torch.infer import predict
from tests.test_torch_engine import CLASSES, NEAR, jax_probabilities, make_models_dir
from tests.torch_threads import torch_threads_share  # noqa: F401

OUT = [48, 48]
REACH = 7


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    return make_models_dir(str(tmp_path_factory.mktemp('models')))


def _dilate(mask, r):
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= np.roll(np.roll(mask, dy, axis=-2), dx, axis=-1)
    return out


def _run_both(models_dir, tmp_path, frames, output_resize='prob_bilinear'):
    dcm = str(tmp_path / 'IMG001')
    jax_dicom.dcmwrite(dcm, frames)
    keys = dict(data_dir=dcm, models_dir=models_dir, output_size=OUT, block_size=8,
                classes=CLASSES, output_resize=output_resize)
    jax_predict.main(JaxConfig(save_dir=str(tmp_path / 'jax'), device='auto', **keys))
    result = predict.main(Config(save_dir=str(tmp_path / 'torch'), device='cpu', **keys))
    return dcm, result


@pytest.mark.parametrize('output_resize', ['prob_bilinear', 'nearest'])
def test_dicom_predict_matches_jax(models_dir, tmp_path, output_resize, monkeypatch):
    # octseg's entry point logs to files under the repo; keep this test in tmp_path
    monkeypatch.setattr('octseg.core.config.setup_logging', lambda *a, **k: None)
    frames = np.random.default_rng(11).integers(0, 255, (5, 64, 64), dtype=np.uint8)
    _dcm, result = _run_both(models_dir, tmp_path, frames, output_resize)
    assert result['frames'] == 5 and set(result['seconds']) >= {'engine', 'render', 'total'}
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'torch'))
    assert len(names) == 10 and 'IMG001_1_overlay.png' in names and 'IMG001_5_mask.png' in names

    probs = jax_probabilities(models_dir, CLASSES, np.repeat(frames[..., None], 3, -1),
                              OUT, output_resize)
    near = (np.abs(probs - 0.5) < NEAR).any(axis=-1)  # (N, H, W)
    assert near.mean() < 1e-3
    for i in range(5):
        for kind, allowed in (('mask', near[i]), ('overlay', _dilate(near[i], REACH))):
            name = f'IMG001_{i + 1}_{kind}.png'
            want = np.asarray(Image.open(tmp_path / 'jax' / name))
            got = np.asarray(Image.open(tmp_path / 'torch' / name))
            assert got.shape == want.shape == (48, 48, 3)
            differ = (got != want).any(axis=-1)
            assert not (differ & ~allowed).any(), f'{name} differs away from p = 0.5'


def test_16bit_pullback_is_normalized_per_slice_as_jax(monkeypatch):
    rng = np.random.default_rng(5)
    frames16 = np.stack([rng.integers(100, 900, (32, 40)), rng.integers(30000, 60000, (32, 40)),
                         np.full((32, 40), 77)]).astype(np.uint16)

    class FakeDataset:
        pixel_array = frames16

    monkeypatch.setattr(jax_dicom, 'dcmread', lambda path: FakeDataset())
    monkeypatch.setattr(predict.dicom, 'dcmread', lambda path: FakeDataset())
    want = jax_predict.load_pullback_frames('unused')
    got = predict.load_pullback_frames('unused')
    assert got.dtype == np.uint8 and got.shape == (3, 32, 40, 1)
    np.testing.assert_array_equal(got, want)


def test_image_directory_is_the_next_slice(models_dir, tmp_path):
    """The image-directory path, once the next slice, now runs: every image
    of the directory gets its overlay and mask PNG at the output size
    (tests/test_torch_predict_images.py holds them against octseg's)."""
    from octseg_torch.data.image import write_png

    rng = np.random.default_rng(4)
    for name in ('a', 'b'):
        write_png(str(tmp_path / f'{name}.png'), rng.integers(0, 255, (30, 40, 3), np.uint8))
    cfg = Config(data_dir=str(tmp_path), models_dir=models_dir, save_dir=str(tmp_path / 'o'),
                 output_size=OUT, classes=CLASSES, device='cpu')
    result = predict.main(cfg)
    assert result['frames'] == 2 and set(result['seconds']) >= {'decode', 'engine', 'render'}
    assert sorted(os.listdir(tmp_path / 'o')) == ['a_mask.png', 'a_overlay.png', 'b_mask.png',
                                                  'b_overlay.png']
    for f in os.listdir(tmp_path / 'o'):
        assert np.asarray(Image.open(tmp_path / 'o' / f)).shape == (*OUT, 3)


@pytest.mark.parametrize('key', ['int8'])
def test_unported_precisions_raise_before_any_model_loads(models_dir, tmp_path, monkeypatch,
                                                          key):
    dcm = str(tmp_path / 'IMG001')
    jax_dicom.dcmwrite(dcm, np.zeros((2, 16, 16), np.uint8))

    def no_model(self, name):
        raise AssertionError(f'model {name} loaded')

    monkeypatch.setattr(predict.InferenceEngine, '_bundle', no_model)
    cfg = Config(data_dir=dcm, models_dir=models_dir, save_dir=str(tmp_path / 'o'),
                 output_size=OUT, classes=CLASSES, device='cpu', **{key: True})
    with pytest.raises(NotImplementedError, match=f'{key}: true is not ported.*ROADMAP.md'):
        predict.main(cfg)
    assert not os.path.exists(tmp_path / 'o')


def test_bf16_predict_runs_the_models_in_bfloat16(models_dir, tmp_path, monkeypatch):
    """``bf16=true`` (once a raising case of the test above) predicts with
    bfloat16 convolutions: every model's convolutions see bfloat16 inputs,
    its parameters stay float32, and the pullback's PNGs are written."""
    dcm = str(tmp_path / 'IMG001')
    jax_dicom.dcmwrite(dcm, np.random.default_rng(2).integers(0, 255, (3, 40, 40), np.uint8))
    seen = set()
    bundle = predict.InferenceEngine._bundle

    def spying(self, name):
        model, cfg = bundle(self, name)
        if name not in seen:
            seen.add(name)
            assert all(p.dtype == torch.float32 for p in model.parameters())
            model.encoder.conv1.register_forward_pre_hook(
                lambda m, a: seen.add((name, a[0].dtype, m.compute_dtype)))
        return model, cfg

    monkeypatch.setattr(predict.InferenceEngine, '_bundle', spying)
    cfg = Config(data_dir=dcm, models_dir=models_dir, save_dir=str(tmp_path / 'o'),
                 output_size=OUT, classes=CLASSES, device='cpu', bf16=True)
    result = predict.main(cfg)
    assert result['frames'] == 3 and len(os.listdir(tmp_path / 'o')) == 6
    assert {s for s in seen if isinstance(s, tuple)} == {
        (name, torch.float32, torch.bfloat16) for name in ('LM', 'FC_LC', 'VV')}


def test_render_mask_block_names_and_sizes(tmp_path):
    frames = np.random.default_rng(6).integers(0, 255, (3, 20, 30, 1), dtype=np.uint8)
    masks = np.zeros((2, 16, 24, 4), np.float32)
    masks[:, 4:9, 5:12, 0] = 1
    predict.render_mask_block(frames, masks, 1, (16, 24), ['Lumen'], str(tmp_path), 'X', 2,
                              device='cpu')
    assert sorted(os.listdir(tmp_path)) == ['X_02_mask.png', 'X_02_overlay.png',
                                           'X_03_mask.png', 'X_03_overlay.png']
    mask = np.asarray(Image.open(tmp_path / 'X_02_mask.png'))
    assert mask.shape == (16, 24, 3)
    assert (mask[5, 6] == (228, 30, 199)).all() and (mask[0, 0] == 128).all()


def test_render_mask_block_defaults_to_the_gpu(tmp_path):
    """Without ``device`` the render path runs on the GPU, or raises where
    there is none: it never drops to the CPU on its own."""
    frames = np.zeros((1, 20, 30, 1), np.uint8)
    masks = np.zeros((1, 16, 24, 4), np.float32)
    if torch.cuda.is_available():
        predict.render_mask_block(frames, masks, 0, (16, 24), ['Lumen'], str(tmp_path), 'X', 1)
        assert sorted(os.listdir(tmp_path)) == ['X_1_mask.png', 'X_1_overlay.png']
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            predict.render_mask_block(frames, masks, 0, (16, 24), ['Lumen'], str(tmp_path),
                                      'X', 1)
        assert os.listdir(tmp_path) == []
