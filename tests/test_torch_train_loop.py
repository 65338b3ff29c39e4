"""octseg_torch's ``train_model`` against the JAX package's, on the CPU.

Both train Unet/resnet18 on the same synthetic fold from the same
``init_weights`` (a flax-initialized weights.ckpt), without augmentation, at
configs/train.yaml's optimizer and learning rate: their metrics.csv must
agree cell by cell. Then the port's own run (augmentation on, resumed), and
its weights.ckpt read by the JAX package.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.core.config import Config as JaxConfig
from octseg.models import create_model as jax_create_model
from octseg.train import checkpoint as jax_ckpt
from octseg.train.metrics import CSV_FIELDS
from octseg.train.train import train_model as jax_train_model
from octseg_torch.core.config import Config
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.models import create_model
from octseg_torch.ops.kernels import warp as k2
from octseg_torch.train import checkpoint as ckpt
from octseg_torch.train.train import train_model

CLASSES = ['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum']


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('loop')
    fold = str(root / 'fold')
    make_synth_fold(fold, n_train=8, n_test=3, size=80, seed=7, n_vis=1)
    init = str(root / 'init')
    jax_ckpt.initialize_model_dir(init, CLASSES, 'Unet', 'resnet18', input_size=64, seed=1,
                                  init_size=32)
    base = dict(data_dir=fold, classes=CLASSES, architecture='Unet', encoder='resnet18',
                optimizer='Adam', lr=1e-5, weight_decay=0.0, input_size=64, batch_size=4,
                epochs=1, use_augmentation=False, seed=11, native_loader=False,
                img_save_interval=1, init_weights=os.path.join(init, 'weights.ckpt'))
    return root, base


def _rows(model_dir):
    with open(os.path.join(model_dir, 'metrics.csv')) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_train_model_matches_jax(setup):
    """One epoch (two steps of 4 samples, one validation batch of 3): Loss
    cells within 1e-4, the other metric cells within 2e-2 (they count
    thresholded pixels, which flip where a logit is near 0)."""
    root, base = setup
    jax_train_model(JaxConfig(dict(base, save_dir=str(root / 'jax'), model_name='m')))
    summary = train_model(Config(dict(base, save_dir=str(root / 'port'), model_name='m')),
                          device='cpu')
    assert summary['epochs_done'] == 1 and summary['train_steps'] == 2
    fields, ours = _rows(str(root / 'port' / 'm'))
    jfields, theirs = _rows(str(root / 'jax' / 'm'))
    assert fields == jfields == CSV_FIELDS
    assert len(ours) == len(theirs) == 2 * (len(CLASSES) + 1)
    for a, b in zip(ours, theirs):
        assert (a['Epoch'], a['Split'], a['Class']) == (b['Epoch'], b['Split'], b['Class'])
        assert abs(float(a['Loss']) - float(b['Loss'])) <= 1e-4, (a, b)
        for name in ('IoU', 'Dice', 'Precision', 'Recall', 'F1'):
            assert abs(float(a[name]) - float(b[name])) <= 2e-2, (name, a, b)
    for name in ('config.json', 'weights.ckpt', 'resume.ckpt', 'scalars.jsonl'):
        assert os.path.exists(root / 'port' / 'm' / name), name
    assert sorted(os.listdir(root / 'port' / 'm' / 'images_per_epoch')) == \
        sorted(os.listdir(root / 'jax' / 'm' / 'images_per_epoch'))


def test_augmented_run_resumes(setup):
    """Augmentation on (K2's plain version on the CPU), one epoch, then
    ``resume=true`` to epoch 2: the CSV continues in octseg's schema and
    row order."""
    root, base = setup
    cfg = Config(dict(base, use_augmentation=True, save_dir=str(root / 'aug'), model_name='m'))
    before = k2.launches
    first = train_model(cfg, device='cpu')
    assert first['epochs_done'] == 1
    cfg['epochs'] = 2
    cfg['resume'] = True
    second = train_model(cfg, device='cpu')
    assert second['epochs_done'] == 2 and second['train_steps'] == 2
    assert k2.launches == before   # CPU tensors take the plain version
    fields, rows = _rows(str(root / 'aug' / 'm'))
    assert fields == CSV_FIELDS
    order = [(r['Epoch'], r['Split'], r['Class']) for r in rows]
    want = [(str(e), s, c) for e in (1, 2) for s in ('train', 'test') for c in CLASSES + ['Mean']]
    assert order == want
    assert all(np.isfinite(float(r['Loss'])) for r in rows)
    # bf16 compute with block remat: one epoch runs, with finite losses
    summary = train_model(Config(dict(cfg, bf16=True, remat=True, resume=False, epochs=1,
                                      model_name='bf16')), device='cpu')
    assert summary['epochs_done'] == 1 and summary['train_steps'] == 2
    _, rows = _rows(str(root / 'aug' / 'bf16'))
    assert rows and all(np.isfinite(float(r['Loss'])) for r in rows)
    assert first['loader'] == second['loader'] == summary['loader'] == 'python'
    # native_loader: true trains through the C++ loader, with finite losses
    summary = train_model(Config(dict(cfg, native_loader=True, resume=False, epochs=1,
                                      model_name='native')), device='cpu')
    assert summary['loader'] == 'native'
    assert summary['epochs_done'] == 1 and summary['train_steps'] == 2
    _, rows = _rows(str(root / 'aug' / 'native'))
    assert rows and all(np.isfinite(float(r['Loss'])) for r in rows)


def test_weights_load_in_the_jax_package(setup):
    """The port's weights.ckpt is the flax layout: octseg's load_weights
    reads it, and its model gives the port's logits within 2e-3."""
    root, base = setup
    model_dir = root / 'port' / 'm'
    if not (model_dir / 'weights.ckpt').exists():
        train_model(Config(dict(base, save_dir=str(root / 'port'), model_name='m')),
                    device='cpu')
    variables = jax_ckpt.load_weights(str(model_dir / 'weights.ckpt'))
    x = np.random.default_rng(0).normal(0, 2, (2, 64, 64, 3)).astype(np.float32)
    want = jax_create_model('Unet', 'resnet18', classes=len(CLASSES)).apply(
        variables, jnp.asarray(x), train=False)
    port = create_model('Unet', 'resnet18', classes=len(CLASSES))
    ckpt.restore_weights_into(port, str(model_dir / 'weights.ckpt'), 'Unet', 'resnet18')
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=0, atol=2e-3)
