"""octseg_torch.train.evaluate against octseg.train.evaluate.

One model dir, trained for a few steps by the port (Unet/resnet18 at 64 px,
Lumen, the shared ``weights.ckpt`` layout), is scored on one synthetic 64 px
fold's test split by both packages. The per-class and mean metrics must
agree within 1e-5; the test first checks that no pixel's probability lies
within 1e-4 of 0.5, where float32 summation order could flip a mask.
"""

import json
import os

import numpy as np
import pytest
import torch

from octseg.train.evaluate import evaluate_model as jax_evaluate_model
from octseg_torch.core.config import Config
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.infer.engine import load_model_bundle
from octseg_torch.ops.normalize import normalize_imagenet
from octseg_torch.train import evaluate
from octseg_torch.train.data import OCTDataset
from octseg_torch.train.train import train_model
from tests.torch_threads import torch_threads_share  # noqa: F401

TOL = 1e-5
NEAR = 1e-4


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('evaluate')
    fold = str(root / 'fold')
    make_synth_fold(fold, n_train=8, n_test=6, size=80, seed=5)
    cfg = Config(data_dir=fold, save_dir=str(root / 'models'), classes=['Lumen'],
                 architecture='Unet', encoder='resnet18', optimizer='Adam', lr=1e-2,
                 input_size=64, batch_size=4, epochs=6, use_augmentation=False, seed=3,
                 model_name='lm')
    summary = train_model(cfg, device='cpu')
    return summary['model_dir'], fold


def test_no_probability_near_one_half(trained):
    model_dir, fold = trained
    model, cfg = load_model_bundle(model_dir, 'cpu')
    data = OCTDataset(os.path.join(fold, 'test'), cfg['classes'], cfg['input_size'])
    imgs = np.stack([data.load(i)[0] for i in range(len(data))])
    with torch.no_grad():
        x = normalize_imagenet(torch.from_numpy(imgs)).permute(0, 3, 1, 2).contiguous()
        probs = torch.sigmoid(model(x)).numpy()
    assert len(data) == 6
    assert not (np.abs(probs - 0.5) < NEAR).any()
    # trained, not saturated: both mask values occur
    assert 0.01 < (probs > 0.5).mean() < 0.99


def test_evaluate_matches_octseg(trained):
    model_dir, fold = trained
    got = evaluate.evaluate_model(model_dir, fold, batch_size=4, device='cpu')
    want = jax_evaluate_model(model_dir, fold, batch_size=4)
    assert list(got) == list(want) == ['Lumen', 'Mean']
    for cl in want:
        assert list(got[cl]) == list(want[cl])
        for k, v in want[cl].items():
            assert abs(got[cl][k] - v) <= TOL, (cl, k, got[cl][k], v)
    assert 0.0 < got['Lumen']['dice'] <= 1.0


def test_main_writes_eval_json(trained):
    model_dir, fold = trained
    results = evaluate.main(Config(model_dir=model_dir, data_dir=fold, split='test',
                                   batch_size=3, device='cpu'))
    with open(os.path.join(model_dir, 'eval_test.json')) as f:
        assert json.load(f) == results


def test_int8_raises_before_the_model_loads(trained, monkeypatch):
    """``int8=True`` (once raised here before the model loaded, the name
    kept) now scores the int8 path: every eligible convolution of the
    model runs it, once per batch, and the metrics stay near exact ones."""
    from octseg_torch.ops import quantize

    model_dir, fold = trained
    calls = []
    real = quantize.quantized_conv
    monkeypatch.setattr(quantize, 'quantized_conv',
                        lambda conv, x, pads: calls.append(conv) or real(conv, x, pads))
    got = evaluate.evaluate_model(model_dir, fold, batch_size=4, int8=True, device='cpu')
    # Unet/resnet18: 24 eligible convolutions, six test frames in batches of 4 and 2
    assert len(calls) == 24 * 2
    exact = evaluate.evaluate_model(model_dir, fold, batch_size=4, device='cpu')
    assert abs(got['Lumen']['dice'] - exact['Lumen']['dice']) <= 1e-2
