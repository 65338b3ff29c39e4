"""Hyperparameter tuning entry point: local Bayesian search and HyperBand
(the port of octseg/tune/tune.py).

Per trial: the next point of ``BayesianSearch`` (random for the first
``n_random`` trials, then GP-EI) sets ``architecture``, ``encoder``,
``optimizer``, ``lr`` and ``input_size`` over configs/tune.yaml, and
``train_model`` trains it into ``{save_dir}/trial_{k:04d}``, reporting each
epoch's validation F1 to the sweep's one ``HyperBand``, which may stop it at
a rung. Each trial appends a row to ``{save_dir}/tuning_results.csv`` with
octseg's ``RESULT_FIELDS``; a trial that raises is logged with its traceback
and recorded as ``failed`` with metric 0, and the sweep goes on.

- Resume: the trials already in tuning_results.csv keep their indices; the
  ``ok`` ones are observed again by the search and seed HyperBand's rungs,
  and the sweep continues at the next index up to ``num_trials``.
- ``warm_start``: another sweep's results file, observed by the search
  only (no trial indices, no rungs).
- ``concurrent_trials: k`` trains ``min(k, CUDA devices)`` trials at once,
  each on its own ``cuda:i`` claimed from a queue of free devices (octseg's
  free-submesh queue); the next point is drawn when a device frees, so it
  sees every trial finished so far. On one card or with ``device=cpu`` the
  trials run one after another. TF32 stays off for the whole sweep (see
  train/folds.py).

Config: configs/tune.yaml (the reference's keys).
Usage: python -m octseg_torch.tune.tune [key=value ...]; ``device=cpu`` off
the card.
"""

from __future__ import annotations

import csv
import logging
import os
import queue
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.infer.engine import fp32_exact
from octseg_torch.train.train import train_model
from octseg_torch.tune.search import BayesianSearch, HyperBand, SearchSpace

log = logging.getLogger(__name__)

RESULT_FIELDS = [
    'trial', 'architecture', 'encoder', 'optimizer', 'lr', 'input_size',
    'val_f1', 'val_loss', 'epochs_done', 'duration_s', 'status',
]

_PARAM_FIELDS = ('architecture', 'encoder', 'optimizer', 'lr', 'input_size')


def _load_completed(results_path: str):
    """Rows of a previous run of a sweep: [(trial, params, val_f1, status,
    epochs_done)]; rows that do not parse are skipped."""
    if not os.path.exists(results_path):
        return []
    out = []
    with open(results_path, newline='') as f:
        for row in csv.DictReader(f):
            try:
                params = {'architecture': row['architecture'], 'encoder': row['encoder'],
                          'optimizer': row['optimizer'], 'lr': float(row['lr']),
                          'input_size': int(row['input_size'])}
                out.append((int(row['trial']), params, float(row['val_f1']),
                            row.get('status', 'ok'),
                            int(float(row.get('epochs_done', 0) or 0))))
            except (KeyError, ValueError):
                continue
    return out


def run_sweep(cfg: Config) -> dict:
    """Run the sweep of ``cfg``; returns the best trial as
    ``{'val_f1', 'params', 'trial'}`` (val_f1 -1 and params None when no
    trial succeeded). Trials take the devices of
    ``octseg_torch.device_pool(cfg.device)``."""
    space = SearchSpace.from_config(cfg)
    search = BayesianSearch(space, seed=cfg.get('seed', 11),
                            n_random=int(cfg.get('n_random', 10)))
    save_dir = cfg.get('save_dir', 'models/tuning')
    os.makedirs(save_dir, exist_ok=True)
    results_path = os.path.join(save_dir, 'tuning_results.csv')
    # one scheduler per sweep: rungs fill across trials
    hyperband = HyperBand(min_iter=int(cfg.get('hyperband_min_iter', 25)),
                          eta=int(cfg.get('hyperband_eta', 2)), max_iter=int(cfg.epochs),
                          s=int(cfg.get('hyperband_s', 2)))

    best = {'val_f1': -1.0, 'params': None}
    start_trial = 0
    for trial, params, val_f1, status, epochs_done in _load_completed(results_path):
        # a failed trial keeps its index but is no measurement: it feeds
        # neither the search nor the rungs
        if status == 'ok':
            search.observe(params, val_f1)
            hyperband.seed(epochs_done, val_f1)
            if val_f1 > best['val_f1']:
                best = {'val_f1': val_f1, 'params': params, 'trial': trial}
        start_trial = max(start_trial, trial + 1)
    if start_trial:
        log.info('resuming sweep at trial %d (best so far %.4f)', start_trial, best['val_f1'])
    warm = cfg.get('warm_start')
    if warm:
        rows = [r for r in _load_completed(str(warm)) if r[3] == 'ok']
        for _trial, params, val_f1, _status, _epochs in rows:
            search.observe(params, val_f1)
        log.info('warm-started from %s (%d observations)', warm, len(rows))

    lock = threading.Lock()
    write_header = not os.path.exists(results_path)
    pool = octseg_torch.device_pool(cfg.get('device'))
    k = max(1, min(int(cfg.get('concurrent_trials', 1)), len(pool)))

    def run_trial(trial: int, params: dict, device: torch.device) -> None:
        nonlocal best, write_header
        trial_cfg = Config(dict(cfg))
        trial_cfg.update(params)
        trial_cfg['model_name'] = f'trial_{trial:04d}'
        trial_cfg['use_augmentation'] = cfg.get('use_augmentation', True)
        log.info('trial %d: %s (on %s)', trial, params, device)
        t0 = time.time()
        status = 'ok'
        try:
            summary = train_model(
                trial_cfg, model_dir=os.path.join(save_dir, f'trial_{trial:04d}'),
                on_epoch_end=lambda epoch, s: hyperband.should_stop(epoch, s['last_val_f1']),
                device=device)
            val_f1, val_loss = summary['last_val_f1'], summary['best_val_loss']
            epochs_done = summary['epochs_done']
        except Exception:
            # trial isolation: the traceback goes to the log, the row says failed
            log.error('trial %d failed:\n%s', trial, traceback.format_exc())
            status, val_f1, val_loss, epochs_done = 'failed', 0.0, float('inf'), 0
        with lock:
            if status == 'ok':
                search.observe(params, val_f1)
                if val_f1 > best['val_f1']:
                    best = {'val_f1': val_f1, 'params': params, 'trial': trial}
            with open(results_path, 'a', newline='') as f:
                writer = csv.DictWriter(f, fieldnames=RESULT_FIELDS)
                if write_header:
                    writer.writeheader()
                    write_header = False
                writer.writerow({'trial': trial, **{key: params[key] for key in _PARAM_FIELDS},
                                 'val_f1': val_f1, 'val_loss': val_loss,
                                 'epochs_done': epochs_done,
                                 'duration_s': round(time.time() - t0, 1), 'status': status})

    trials = range(start_trial, int(cfg.num_trials))
    with fp32_exact():
        if k == 1:
            for trial in trials:
                with lock:
                    params = search.suggest()
                run_trial(trial, params, pool[0])
        else:
            # a slot frees when a trial ends; the next point is drawn then,
            # so it sees every trial finished before (octseg's async dispatch)
            free_devices: 'queue.Queue[torch.device]' = queue.Queue()
            for dev in pool[:k]:
                free_devices.put(dev)
            slots = threading.Semaphore(k)

            def run_on_free_device(trial: int, params: dict) -> None:
                dev = free_devices.get()
                try:
                    run_trial(trial, params, dev)
                finally:
                    free_devices.put(dev)
                    slots.release()

            with ThreadPoolExecutor(k) as executor:
                futures = []
                for trial in trials:
                    slots.acquire()
                    with lock:
                        params = search.suggest()
                    futures.append(executor.submit(run_on_free_device, trial, params))
                for fut in futures:
                    fut.result()
    log.info('Best trial: %s', best)
    return best


@entry_point('tune')
def main(cfg: Config) -> dict:
    best = run_sweep(cfg)
    log.info('Complete')
    return best


if __name__ == '__main__':
    main()
