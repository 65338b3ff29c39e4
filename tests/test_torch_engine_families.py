"""octseg_torch's InferenceEngine against the JAX package's engine with the
three model families of the reference's ensemble at small widths:
UnetPlusPlus/resnet18 (LM), LinkNet/efficientnet-b0 (FC_LC) and
Unet/timm-regnetx_002 (VV) at 64 px, four classes, octseg-trained manifests
(``normalize: true``), weights from octseg_torch's initializer with the
head's kernel scaled by 1/20 and its bias drawn from N(0, 0.5). Unscaled,
these models saturate (|logit| about 40 on the reference's 0..255 inputs):
bilinear output weights between p = 0 and p = 1 then put whole rows of
pixels at p = 0.5 exactly, and LinkNet's pixels whose last ReLU features are
all 0 (about 3%) have a logit of exactly the zero bias. Scaled, most pixels
have a probability that a wrong forward would move across 0.5.

The port's memory probe is replaced by one that reports a peak of 1e12
bytes per frame, so every model runs its block in chunks smaller than the
block, each model in its own chunk. The masks must equal the JAX engine's
except where the JAX probability lies within 1e-4 of 0.5 (the rule of
tests/test_torch_engine.py), in both output modes.
"""

import itertools
import os

import numpy as np
import pytest

from octseg.infer.engine import InferenceEngine as JaxEngine
from octseg_torch.infer.engine import CHUNK_MARGIN, InferenceEngine
from octseg_torch.train.checkpoint import initialize_model_dir, load_weights, save_weights
from tests.test_torch_engine import CASES, CLASSES, OUT, assert_masks_agree, jax_probabilities
from tests.test_torch_engine import make_frames

FAMILIES = (('LM', ['Lumen'], 'UnetPlusPlus', 'resnet18'),
            ('FC_LC', ['Lipid core', 'Fibrous cap'], 'LinkNet', 'efficientnet-b0'),
            ('VV', ['Vasa vasorum'], 'Unet', 'timm-regnetx_002'))
PER_FRAME = 1e12
# free bytes the fake probe reports, model by model in the plan's order
# (LM, FC_LC, VV): chunks 2, 1 and 2 of a 4-frame block
AVAILABLE = (2.5 * PER_FRAME / CHUNK_MARGIN, 1.5 * PER_FRAME / CHUNK_MARGIN,
             3.5 * PER_FRAME / CHUNK_MARGIN)
CHUNKS = {'LM': 2, 'FC_LC': 1, 'VV': 2}


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('families'))
    for seed, (name, classes, arch, encoder) in enumerate(FAMILIES):
        model_dir = initialize_model_dir(os.path.join(root, name), classes, arch, encoder,
                                         input_size=64, seed=seed)
        path = os.path.join(model_dir, 'weights.ckpt')
        variables = load_weights(path)
        head = variables['params']['head']['Conv_0']
        head['kernel'] = head['kernel'] / 20
        head['bias'] = np.random.default_rng(seed).normal(0, 0.5, head['bias'].shape).astype(
            np.float32)
        save_weights(path, variables['params'], variables['batch_stats'])
    return root


@pytest.fixture
def probed(monkeypatch):
    """A fake probe: fixed 0 bytes, PER_FRAME bytes per frame, AVAILABLE
    free bytes in turn; nothing allocated."""
    available = itertools.cycle(AVAILABLE)

    def probe(self, forward, frame_shape):
        return [(2, 2 * PER_FRAME), (4, 4 * PER_FRAME)], 0, next(available)

    monkeypatch.setattr(InferenceEngine, '_memory_probe', probe)


@pytest.fixture(scope='module')
def jax_results(models_dir):
    out = {}
    for mode, kind in CASES:
        frames = make_frames(kind)
        engine = JaxEngine(models_dir, CLASSES, block_size=8, output_resize=mode)
        out[(mode, kind)] = (frames, engine.segment_pullback(frames, OUT),
                             jax_probabilities(models_dir, CLASSES, frames, OUT, mode))
    return out


def _counting_engine(models_dir, mode):
    engine = InferenceEngine(models_dir, CLASSES, block_size=4, output_resize=mode,
                             device='cpu')
    calls = {}
    for name, *_ in FAMILIES:
        model, _cfg = engine._bundle(name)
        model.register_forward_hook(
            lambda m, i, o, name=name: calls.setdefault(name, []).append(i[0].shape[0]))
    return engine, calls


@pytest.mark.parametrize('mode,kind', CASES)
def test_iter_pullback_in_chunks_matches_jax(models_dir, jax_results, probed, mode, kind):
    frames, want, probs = jax_results[(mode, kind)]
    engine, calls = _counting_engine(models_dir, mode)
    blocks = list(engine.iter_pullback(frames, OUT))
    assert [(s, b.shape[0]) for s, b in blocks] == [(0, 4), (4, 1)]
    assert {key[0]: plan.chunk for key, plan in engine.chunk_plans.items()} == CHUNKS
    # 5 frames: a block of 4 in chunks, then a block of 1
    assert calls == {'LM': [2, 2, 1], 'FC_LC': [1, 1, 1, 1, 1], 'VV': [2, 2, 1]}
    assert_masks_agree(np.concatenate([b for _, b in blocks]), want, probs)


@pytest.mark.parametrize('mode,kind', CASES)
def test_segment_pullback_in_chunks_matches_jax(models_dir, jax_results, probed, mode, kind):
    frames, want, probs = jax_results[(mode, kind)]
    engine, calls = _counting_engine(models_dir, mode)
    got = engine.segment_pullback(frames, OUT)
    assert {name: len(c) for name, c in calls.items()} == {'LM': 3, 'FC_LC': 5, 'VV': 3}
    assert_masks_agree(got, want, probs)
