"""octseg_torch's InferenceEngine against the JAX package's engine.

Both engines run the same model dirs on the same frames: the three
random-weight Unet/resnet18 dirs at 64 px of tests/test_infer.py (same
manifests: no ``normalize`` key, so the reference's raw-BGR quirk path),
with weights from octseg_torch's initializer, which is faster than a flax
init. Their masks must be equal except at
pixels where the JAX probability lies within 1e-4 of 0.5, where float32
summation order may decide the threshold; those pixels must stay under 0.1%.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.infer.engine import InferenceEngine as JaxEngine
from octseg.infer.engine import load_model_bundle as jax_load_model_bundle
from octseg.ops.normalize import normalize_imagenet
from octseg.ops.resize import resize_bilinear, resize_nearest
from octseg.parallel.sharding import make_mesh
from octseg_torch import resolve_device
from octseg_torch.infer.engine import CHUNK_MARGIN, MODELS_META, InferenceEngine, choose_chunk
from octseg_torch.train.checkpoint import initialize_model_dir

CLASSES = ['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum']
OUT = (48, 56)
NEAR = 1e-4           # |p - 0.5| below which a pixel may flip
MAX_NEAR_SHARE = 1e-3


def make_models_dir(root):
    """tests/test_infer.py's three model dirs (its manifest keys)."""
    for seed, (name, classes) in enumerate((('LM', ['Lumen']),
                                            ('FC_LC', ['Lipid core', 'Fibrous cap']),
                                            ('VV', ['Vasa vasorum']))):
        model_dir = initialize_model_dir(os.path.join(root, name), classes, 'Unet',
                                         'resnet18', input_size=64, seed=seed)
        with open(os.path.join(model_dir, 'config.json')) as f:
            cfg = json.load(f)
        del cfg['normalize']
        with open(os.path.join(model_dir, 'config.json'), 'w') as f:
            json.dump(cfg, f)
    return root


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    return make_models_dir(str(tmp_path_factory.mktemp('models')))


def make_frames(kind, n=5, h=70, w=90, seed=0):
    rng = np.random.default_rng(seed)
    if kind == 'mono':  # grayscale replicated to RGB: the engines' mono upload
        return np.repeat(rng.integers(0, 256, (n, h, w, 1), dtype=np.uint8), 3, axis=-1)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


_JAX_MODELS = {}  # model dir -> (jitted apply, variables, manifest)


def _jax_model(model_dir):
    if model_dir not in _JAX_MODELS:
        model, variables, cfg = jax_load_model_bundle(model_dir)
        apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
        _JAX_MODELS[model_dir] = (apply, variables, cfg)
    return _JAX_MODELS[model_dir]


def jax_probabilities(models_dir, classes, frames, out_size, mode):
    """(N, out_h, out_w, 4) probabilities the JAX engine thresholds, in the
    routed channels: its forward with sigmoid in place of the threshold."""
    from octseg.core.registry import CLASS_IDS

    probs = np.full((frames.shape[0], *out_size, 4), np.nan, np.float32)
    plan = {}
    for c in classes:
        plan.setdefault(MODELS_META[c]['model_dir'], []).append(c)
    for name, routed in plan.items():
        apply, variables, cfg = _jax_model(os.path.join(models_dir, name))
        s = cfg['input_size']
        x = resize_bilinear(jnp.asarray(frames[..., ::-1], jnp.float32), (s, s))
        if cfg.get('normalize', False):
            x = normalize_imagenet(x)
        logits = apply(variables, x)
        p = jax.nn.sigmoid(logits)
        p = resize_bilinear(p, out_size) if mode == 'prob_bilinear' else resize_nearest(p, out_size)
        for c in routed:
            probs[..., CLASS_IDS[c] - 1] = np.asarray(p[..., MODELS_META[c]['index']])
    return probs


def assert_masks_agree(got, want, probs):
    near = np.abs(probs - 0.5) < NEAR
    assert got.shape == want.shape
    assert not ((got != want) & ~near).any(), 'masks differ away from p = 0.5'
    assert near.mean() < MAX_NEAR_SHARE, f'{near.mean():.2e} of pixels within {NEAR} of 0.5'


# both output_resize modes and both uploads (RGB, mono)
CASES = [('prob_bilinear', 'rgb'), ('nearest', 'mono')]


@pytest.fixture(scope='module')
def jax_results(models_dir):
    """JAX engine masks and probabilities per case, computed once."""
    out = {}
    for mode, kind in CASES:
        frames = make_frames(kind)
        engine = JaxEngine(models_dir, CLASSES, block_size=8, output_resize=mode)
        seg = engine.segment_pullback(frames, OUT)
        blocks = list(engine.iter_pullback(frames, OUT))
        out[(mode, kind)] = (frames, seg, blocks,
                             jax_probabilities(models_dir, CLASSES, frames, OUT, mode))
    return out


@pytest.mark.parametrize('mode,kind', CASES)
def test_segment_pullback_matches_jax(models_dir, jax_results, mode, kind):
    frames, want, _blocks, probs = jax_results[(mode, kind)]
    engine = InferenceEngine(models_dir, CLASSES, block_size=3, output_resize=mode,
                             device='cpu')
    got = engine.segment_pullback(frames, OUT)
    assert got.dtype == np.float32
    assert_masks_agree(got, want, probs)


@pytest.mark.parametrize('mode,kind', CASES)
def test_iter_pullback_matches_jax(models_dir, jax_results, mode, kind):
    frames, want, jax_blocks, probs = jax_results[(mode, kind)]
    engine = InferenceEngine(models_dir, CLASSES, block_size=2, output_resize=mode,
                             device='cpu')
    blocks = list(engine.iter_pullback(frames, OUT))
    assert [s for s, _ in blocks] == [0, 2, 4]
    assert [b.shape[0] for _, b in blocks] == [2, 2, 1]
    got = np.concatenate([b for _, b in blocks])
    assert_masks_agree(got, want, probs)
    assert_masks_agree(got, np.concatenate([b for _, b in jax_blocks]), probs)


def test_mono_upload_only_for_gray_pullbacks():
    gray = make_frames('mono')
    assert InferenceEngine._as_mono_if_gray(gray).shape[-1] == 1
    color = make_frames('rgb')
    assert InferenceEngine._as_mono_if_gray(color) is color


def test_each_model_runs_once_per_block(models_dir):
    """FC_LC serves two classes but runs once per block."""
    engine = InferenceEngine(models_dir, CLASSES, block_size=2, device='cpu')
    calls = {}
    for name in ('LM', 'FC_LC', 'VV'):
        model, _cfg = engine._bundle(name)
        model.register_forward_hook(
            lambda m, i, o, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    masks = engine.segment_pullback(make_frames('rgb'), OUT)
    assert calls == {'LM': 3, 'FC_LC': 3, 'VV': 3}
    assert masks.shape == (5, *OUT, 4)


def test_classes_subset_routes_only_its_channels(models_dir):
    engine = InferenceEngine(models_dir, ['Fibrous cap'], block_size=4, device='cpu')
    assert engine._ensemble_plan() == {'FC_LC': [('Fibrous cap', 1, 1)]}
    masks = engine.segment_pullback(make_frames('rgb'), OUT)
    assert not masks[..., [0, 2, 3]].any()
    assert list(engine._bundles) == ['FC_LC']


def test_engine_arguments_are_checked(models_dir):
    with pytest.raises(ValueError):
        InferenceEngine(models_dir, CLASSES, output_resize='bicubic', device='cpu')
    with pytest.raises(ValueError):
        InferenceEngine(models_dir, CLASSES, block_size=0, device='cpu')
    with pytest.raises(TypeError):
        next(InferenceEngine(models_dir, CLASSES, device='cpu').iter_pullback(
            torch.zeros(2, 8, 8, 3, dtype=torch.uint8), OUT))


@pytest.mark.parametrize('block_size', [1, 3, 100, 128, 129])
def test_block_size_is_floored_to_a_power_of_two_as_jax(models_dir, block_size):
    """octseg floors its per-device quota to a power of two; on one device
    the block is that quota."""
    want = JaxEngine(models_dir, CLASSES, block_size=block_size,
                     mesh=make_mesh(devices=jax.devices()[:1])).block_size
    got = InferenceEngine(models_dir, CLASSES, block_size=block_size, device='cpu').block_size
    assert got == want == 1 << (block_size.bit_length() - 1)


def test_resolve_device():
    assert resolve_device('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            InferenceEngine('.', CLASSES)


def test_choose_chunk_takes_the_largest_that_fits():
    """Fixed 1000 bytes plus 100 per frame, measured at 2 and 4 frames."""
    probes = [(2, 1200), (4, 1400)]
    assert choose_chunk(128, probes, 10 ** 6) == (128, 100.0, 13800.0)
    assert choose_chunk(128, probes, 7400) == (64, 100.0, 7400.0)
    assert choose_chunk(128, probes, 7399) == (32, 100.0, 4200.0)
    assert choose_chunk(32, probes, 1100) == (1, 100.0, 1100.0)
    # a block that is not a power of two (a short pullback): then powers of two
    assert choose_chunk(5, probes, 1500) == (5, 100.0, 1500.0)
    assert choose_chunk(5, probes, 1499) == (4, 100.0, 1400.0)
    with pytest.raises(RuntimeError, match='one frame needs'):
        choose_chunk(128, probes, 1099)


def test_chunk_is_decided_once_per_shape_and_raises_when_one_frame_does_not_fit(
        models_dir, monkeypatch):
    calls = []

    def probe(self, forward, frame_shape):
        calls.append(tuple(frame_shape))
        # 1 GiB per frame, 2 frames' worth free
        return [(2, 2 << 30), (4, 4 << 30)], 0, int((2 << 30) / CHUNK_MARGIN) + 10 ** 7

    monkeypatch.setattr(InferenceEngine, '_memory_probe', probe)
    engine = InferenceEngine(models_dir, ['Lumen'], block_size=8, device='cpu')
    frames = make_frames('rgb')
    masks = engine.segment_pullback(frames, OUT)
    engine.segment_pullback(frames, OUT)
    assert calls == [(5, 70, 90, 3)]
    plan = engine.chunk_plans[('LM', 'pullback', (5, 70, 90, 3), OUT)]
    assert plan.chunk == 2 and plan.bytes_per_frame == 1 << 30
    # beside the chunk: two blocks of frames and two of LM's packed masks
    resident = 2 * (5 * 70 * 90 * 3 + 5 * OUT[0] * (OUT[1] // 8))
    assert plan.predicted_peak_bytes == (2 << 30) + resident
    assert plan.budget_bytes == int(CHUNK_MARGIN * (int((2 << 30) / CHUNK_MARGIN) + 10 ** 7
                                                    - resident))
    np.testing.assert_array_equal(
        masks, InferenceEngine(models_dir, ['Lumen'], block_size=8, device='cpu')
        .segment_pullback(frames, OUT))

    monkeypatch.setattr(InferenceEngine, '_memory_probe',
                        lambda self, forward, frame_shape: ([(2, 2 << 30), (4, 4 << 30)], 0,
                                                            1 << 30))
    with pytest.raises(RuntimeError, match='one frame needs'):
        InferenceEngine(models_dir, ['Lumen'], block_size=8, device='cpu').segment_pullback(
            frames, OUT)
