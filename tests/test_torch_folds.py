"""octseg_torch.train.folds: octseg's cross-validation layout.

Two synthetic 64 px folds, one epoch each, on the CPU. The summary CSV must
be what octseg's ``train_folds`` writes for the same per-fold summaries (its
``train_model`` replaced by one that returns the port's), apart from the
wall-clock ``duration_s``; each fold's model dir must hold, byte for byte,
what ``train_model`` writes alone with the same config and seed.
"""

import csv
import os

import pytest

from octseg_torch.core.config import Config
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.train import folds
from octseg_torch.train.train import train_model
from tests.torch_threads import torch_threads_share  # noqa: F401

MODEL_FILES = ('weights.ckpt', 'resume.ckpt', 'metrics.csv', 'scalars.jsonl', 'config.json')


def fold_config(cv_dir, save_dir, **keys):
    return Config(dict(dict(cv_dir=cv_dir, folds=[1, 2], save_dir=save_dir, classes=['Lumen'],
                            architecture='Unet', encoder='resnet18', optimizer='Adam', lr=1e-3,
                            input_size=64, batch_size=2, epochs=1, use_augmentation=True,
                            seed=7, device='cpu', concurrent_folds=2), **keys))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp('folds')
    cv_dir = str(root / 'cv')
    for k in (1, 2):
        make_synth_fold(os.path.join(cv_dir, f'fold_{k}'), n_train=4, n_test=2, size=72,
                        seed=k)
    cfg = fold_config(cv_dir, str(root / 'models'))
    return cfg, root, folds.train_folds(cfg)


def _read_csv(path):
    with open(path, newline='') as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_summary_csv_is_octseg_layout(run, tmp_path, monkeypatch):
    import octseg.train.folds as jax_folds
    from octseg.core.config import Config as JaxConfig

    cfg, _root, results = run
    assert [r['fold'] for r in results] == [1, 2]
    assert all(r['epochs_done'] == 1 for r in results)
    fields, rows = _read_csv(os.path.join(cfg.save_dir, 'Unet_resnet18', 'folds_summary.csv'))
    by_fold = {r['fold']: r for r in results}

    def replay(fold_cfg, model_dir=None, devices=None):
        fold = int(fold_cfg['data_dir'].rsplit('_', 1)[1])
        return {k: v for k, v in by_fold[fold].items() if k not in ('fold', 'duration_s')}

    monkeypatch.setattr(jax_folds, 'train_model', replay)
    jax_folds.train_folds(JaxConfig(dict(cfg, save_dir=str(tmp_path), concurrent_folds=1)))
    want_fields, want_rows = _read_csv(os.path.join(tmp_path, 'Unet_resnet18',
                                                    'folds_summary.csv'))
    assert fields == want_fields == folds.SUMMARY_FIELDS
    assert len(rows) == len(want_rows) == 2
    for got, want in zip(rows, want_rows):
        for key in ('fold', 'best_val_loss', 'last_val_f1', 'epochs_done'):
            assert got[key] == want[key]
        float(got['duration_s'])


def test_fold_dirs_equal_train_model_alone(run, tmp_path):
    cfg, _root, _results = run
    fold_cfg = Config(dict(cfg, data_dir=os.path.join(cfg.cv_dir, 'fold_2'),
                           model_name='Unet_resnet18/fold_2'))
    alone = train_model(fold_cfg, model_dir=str(tmp_path / 'alone'), device='cpu')['model_dir']
    fold_dir = os.path.join(cfg.save_dir, 'Unet_resnet18', 'fold_2')
    for name in MODEL_FILES:
        with open(os.path.join(fold_dir, name), 'rb') as a, open(os.path.join(alone, name),
                                                               'rb') as b:
            assert a.read() == b.read(), name
    assert os.path.isfile(os.path.join(cfg.save_dir, 'Unet_resnet18', 'fold_1', 'weights.ckpt'))


def test_concurrent_folds_run_one_at_a_time_on_the_cpu(run, monkeypatch, tmp_path):
    """``concurrent_folds: 2`` with ``device=cpu`` trains the folds in order
    on the one device."""
    cfg, _root, _results = run
    seen = []

    def fake_train(fold_cfg, model_dir=None, device=None):
        seen.append((fold_cfg['data_dir'][-6:], str(device)))
        return {'best_val_loss': 0.5, 'last_val_f1': 0.5, 'epochs_done': 1}

    monkeypatch.setattr(folds, 'train_model', fake_train)
    folds.train_folds(Config(dict(cfg, save_dir=str(tmp_path), folds=[1, 2, 3])))
    assert seen == [('fold_1', 'cpu'), ('fold_2', 'cpu'), ('fold_3', 'cpu')]
