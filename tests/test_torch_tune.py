"""octseg_torch.tune against octseg.tune on the CPU.

- ``SearchSpace`` encodes and samples as octseg's.
- The numpy GP against sklearn's ``GaussianProcessRegressor(Matern(nu=2.5),
  alpha=1e-4, normalize_y=True)`` (what octseg fits): on 40 random
  observation sets drawn from configs/tune.yaml's encoding, the fitted
  length scale within 1e-5 relative and the predictive mean and std within
  1e-6. The likelihood has several local maxima on some sets, and sklearn's
  L-BFGS-B does not always stop at the one nearest its start: the control,
  which takes that nearest maximum, must miss sklearn's length scale on one
  of these sets at least.
- ``BayesianSearch`` makes the same 25 suggestions as octseg's (which has
  sklearn here) under interleaved ``observe`` calls on a fixed objective,
  20 of them from the GP; ``HyperBand`` decides as octseg's and ``seed``
  restores the same thresholds.
- ``run_sweep`` end to end (Unet/resnet18 at 64 px, one epoch): octseg's
  ``RESULT_FIELDS``, octseg's random draws as the trials' points, resume
  (only the new trial runs), warm start (observations only, no indices), and
  a trial that raises recorded as ``failed`` while the sweep goes on. Each
  trial's checkpoints are checked and then deleted (``light_trials``).
"""

import csv
import math
import os
import warnings

import numpy as np
import pytest
import torch
from sklearn.gaussian_process import GaussianProcessRegressor
from sklearn.gaussian_process.kernels import Matern

from octseg.core.config import load_config as jax_load_config
from octseg.tune.search import BayesianSearch as JaxBayesianSearch
from octseg.tune.search import HyperBand as JaxHyperBand
from octseg.tune.search import SearchSpace as JaxSearchSpace
from octseg.tune.tune import RESULT_FIELDS as JAX_RESULT_FIELDS
from octseg_torch.core.config import Config, load_config
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.tune import tune
from octseg_torch.tune.search import BayesianSearch, GaussianProcess, HyperBand, SearchSpace


@pytest.fixture(scope='module')
def spaces():
    return (SearchSpace.from_config(load_config('tune')),
            JaxSearchSpace.from_config(jax_load_config('tune')))


def test_search_space_encodes_as_octseg(spaces):
    space, jax_space = spaces
    assert space.params == jax_space.params and space.size == jax_space.size == 9 * 9 * 3 * 4 * 4
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(50):
        p = space.sample(a)
        assert p == jax_space.sample(b)
        np.testing.assert_array_equal(space.encode(p), jax_space.encode(p))


def _observation_sets(space, count=40, seed=0):
    """(x, y) sets of 1-39 tune.yaml points: uniform metrics, metrics close
    together, a metric driven by the architecture, and some failed (0)."""
    rng = np.random.default_rng(seed)
    for case in range(count):
        n = int(rng.integers(1, 40))
        x = np.stack([space.encode(space.sample(rng)) for _ in range(n)])
        y = [rng.random(n), 0.9 + 0.01 * rng.random(n), x[:, 0] * 0.5 + rng.normal(0, 0.01, n),
             np.where(rng.random(n) < 0.3, 0.0, rng.random(n))][case % 4]
        yield x, y, np.stack([space.encode(space.sample(rng)) for _ in range(64)])


def _nearest_maximum(gp):
    """The control: the log length scale of the likelihood maximum nearest
    to the start 0 in its ascent direction, by bisection."""
    lo_b, hi_b = gp.BOUNDS
    sign = 1.0 if gp.log_marginal_likelihood(0.0)[1] > 0 else -1.0
    a, b = 0.0, sign
    while sign * gp.log_marginal_likelihood(b)[1] > 0 and lo_b < b < hi_b:
        a, b = b, max(lo_b, min(hi_b, b + sign * abs(b)))
    for _ in range(100):
        mid = 0.5 * (a + b)
        a, b = (mid, b) if sign * gp.log_marginal_likelihood(mid)[1] > 0 else (a, mid)
    return math.exp(0.5 * (a + b))


def test_gp_matches_sklearn(spaces):
    space, _ = spaces
    worst = {'length_scale': 0.0, 'mean': 0.0, 'std': 0.0}
    control_misses = 0
    for x, y, query in _observation_sets(space):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')   # sklearn's convergence notes
            want = GaussianProcessRegressor(kernel=Matern(nu=2.5), alpha=1e-4,
                                            normalize_y=True).fit(x, y)
        got = GaussianProcess().fit(x, y)
        scale = want.kernel_.length_scale
        worst['length_scale'] = max(worst['length_scale'], abs(got.length_scale - scale) / scale)
        mean, std = want.predict(query, return_std=True)
        got_mean, got_std = got.predict(query)
        worst['mean'] = max(worst['mean'], np.abs(got_mean - mean).max())
        worst['std'] = max(worst['std'], np.abs(got_std - std).max())
        control_misses += abs(_nearest_maximum(got) - scale) / scale > 1e-5
    assert worst['length_scale'] <= 1e-5 and worst['mean'] <= 1e-6 and worst['std'] <= 1e-6, \
        worst
    assert control_misses >= 1


def _objective(p):
    return ({'Unet': 0.3, 'FPN': 0.25, 'DeepLabV3Plus': 0.2}.get(p['architecture'], 0.0)
            + 0.2 * (p['lr'] == 1e-4) + 0.1 * p['input_size'] / 896
            + 0.05 * p['encoder'].startswith('efficientnet'))


@pytest.mark.parametrize('seed', [11, 3])
def test_bayesian_search_suggests_as_octseg(spaces, seed):
    space, jax_space = spaces
    ours, theirs = BayesianSearch(space, seed=seed, n_random=5), \
        JaxBayesianSearch(jax_space, seed=seed, n_random=5)
    noise = np.random.default_rng(seed + 100)
    for _ in range(25):
        p = ours.suggest()
        assert p == theirs.suggest()
        value = _objective(p) + noise.normal(0, 0.01)
        ours.observe(p, value)
        theirs.observe(p, value)
    assert ours.rng.integers(2 ** 31) == theirs.rng.integers(2 ** 31)


def test_hyperband_decides_as_octseg():
    rng = np.random.default_rng(0)
    ours, theirs = HyperBand(min_iter=2, eta=2, max_iter=16, s=2), \
        JaxHyperBand(min_iter=2, eta=2, max_iter=16, s=2)
    assert ours.rungs == theirs.rungs == [2, 4, 8]
    for _ in range(200):
        epoch, metric = int(rng.integers(1, 10)), float(rng.random())
        assert ours.should_stop(epoch, metric) == theirs.should_stop(epoch, metric)
    resumed, jax_resumed = HyperBand(min_iter=25, eta=2, max_iter=50), \
        JaxHyperBand(min_iter=25, eta=2, max_iter=50)
    for done, v in ((50, 0.9), (50, 0.8), (10, 0.95), (25, 0.7)):
        resumed.seed(done, v)
        jax_resumed.seed(done, v)
    assert resumed.history == jax_resumed.history == {25: [0.9, 0.8, 0.7]}
    for v in (0.1, 0.85, 0.95):
        assert resumed.should_stop(25, v) == jax_resumed.should_stop(25, v)


@pytest.fixture(scope='module')
def fold(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('tune') / 'fold')
    make_synth_fold(path, n_train=4, n_test=2, size=80, seed=6)
    return path


@pytest.fixture
def one_thread():
    """One intra-op thread while the sweeps train: the test runner's
    workers share the cores, and eight threads per worker oversubscribe
    them (a sweep ran 15 times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def light_trials(monkeypatch):
    """Each trial's weights.ckpt and resume.ckpt must be written; then they
    are deleted, since a Unet/resnet18 trial writes 228 MB of them and the
    test runner's temporary disk is shared."""
    real = tune.train_model

    def train_model(cfg, model_dir=None, on_epoch_end=None, device=None):
        summary = real(cfg, model_dir=model_dir, on_epoch_end=on_epoch_end, device=device)
        for name in ('weights.ckpt', 'resume.ckpt'):
            path = os.path.join(model_dir, name)
            assert os.path.isfile(path), path
            os.remove(path)
        return summary

    monkeypatch.setattr(tune, 'train_model', train_model)


def _cfg(fold, save_dir, num_trials, **overrides):
    cfg = Config(load_config('tune', [f'data_dir={fold}', f'save_dir={save_dir}', 'device=cpu',
                                      'architecture=[Unet]', 'encoder=[resnet18]',
                                      'optimizer=[Adam,RMSprop]',
                                      'learning_rate=[0.001,0.0001,0.0003]',
                                      'input_size_min=64', 'input_size_max=64',
                                      'batch_size=4', 'epochs=1', 'classes=[Lumen]',
                                      f'num_trials={num_trials}']).to_dict())
    cfg.update(overrides)
    return cfg


def _rows(save_dir):
    with open(os.path.join(save_dir, 'tuning_results.csv'), newline='') as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_run_sweep_resume_and_warm_start(tmp_path, fold, monkeypatch, one_thread,
                                         light_trials):
    save_dir = str(tmp_path / 'sweep')
    best = tune.run_sweep(_cfg(fold, save_dir, 3))
    fields, rows = _rows(save_dir)
    assert fields == tune.RESULT_FIELDS == JAX_RESULT_FIELDS
    assert [r['trial'] for r in rows] == ['0', '1', '2']
    assert {r['status'] for r in rows} == {'ok'} and {r['epochs_done'] for r in rows} == {'1'}
    assert all(float(r['duration_s']) > 0 for r in rows)
    # fewer ok trials than n_random (10): octseg's random draws, in order
    jax_search = JaxBayesianSearch(JaxSearchSpace.from_config(_cfg(fold, save_dir, 3)), seed=11)
    for row in rows:
        want = jax_search.suggest()
        assert (row['architecture'], row['encoder'], row['optimizer'], float(row['lr']),
                int(row['input_size'])) == tuple(want[k] for k in (
                    'architecture', 'encoder', 'optimizer', 'lr', 'input_size'))
    assert best['val_f1'] == max(float(r['val_f1']) for r in rows)
    for r in rows:
        assert os.path.isfile(os.path.join(save_dir, f'trial_{int(r["trial"]):04d}',
                                           'metrics.csv'))

    # resume: num_trials 4 runs trial 3 alone
    tune.run_sweep(_cfg(fold, save_dir, 4))
    _, rows_after = _rows(save_dir)
    assert [r['trial'] for r in rows_after] == ['0', '1', '2', '3']
    assert rows_after[:3] == rows

    # warm start from that file: observations only, the new sweep's trials
    # start at 0
    warm_dir = str(tmp_path / 'warm')
    observed = []
    real_observe = BayesianSearch.observe

    def observe(self, point, value):
        observed.append(point)
        real_observe(self, point, value)

    monkeypatch.setattr(BayesianSearch, 'observe', observe)
    tune.run_sweep(_cfg(fold, warm_dir, 1, warm_start=os.path.join(save_dir,
                                                                    'tuning_results.csv')))
    _, warm_rows = _rows(warm_dir)
    assert [r['trial'] for r in warm_rows] == ['0']
    assert len(observed) == 4 + 1     # the four warm rows, then the new trial


def test_failed_trial_is_recorded_and_the_sweep_goes_on(tmp_path, fold, monkeypatch,
                                                        one_thread, light_trials):
    real = tune.train_model

    def train_model(cfg, model_dir=None, on_epoch_end=None, device=None):
        if cfg.model_name == 'trial_0001':
            raise RuntimeError('injected fault')
        return real(cfg, model_dir=model_dir, on_epoch_end=on_epoch_end, device=device)

    monkeypatch.setattr(tune, 'train_model', train_model)
    save_dir = str(tmp_path / 'sweep')
    best = tune.run_sweep(_cfg(fold, save_dir, 3))
    _, rows = _rows(save_dir)
    assert [(r['trial'], r['status']) for r in rows] == [('0', 'ok'), ('1', 'failed'),
                                                        ('2', 'ok')]
    assert float(rows[1]['val_f1']) == 0.0 and rows[1]['val_loss'] == 'inf'
    assert best['trial'] in (0, 2)
    # rerun: the failed trial keeps its index and is not observed again
    observed = []
    real_observe = BayesianSearch.observe

    def observe(self, point, value):
        observed.append(point)
        real_observe(self, point, value)

    monkeypatch.setattr(BayesianSearch, 'observe', observe)
    tune.run_sweep(_cfg(fold, save_dir, 3))
    _, again = _rows(save_dir)
    assert again == rows and len(observed) == 2
