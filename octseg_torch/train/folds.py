"""Cross-validation driver: train every fold of a CV directory.

The port of octseg/train/folds.py: one config, all folds, each through
``train_model`` into ``{save_dir}/{run_name}/fold_{k}`` (the model-dir
files: weights.ckpt, config.json, metrics.csv, resume.ckpt), then
``folds_summary.csv`` with the header
``fold,best_val_loss,last_val_f1,epochs_done,duration_s``.

Folds are independent: ``concurrent_folds: k`` trains ``min(k, CUDA device
count, folds)`` folds at a time, each on its own ``cuda:i``, claimed from a
queue of free devices and returned when its fold ends (octseg's free-submesh
queue). On one card or with ``device=cpu`` the folds run one after another.
TF32 stays off for the whole run: ``fp32_exact`` switches process-wide
flags, so it is held here around all the folds and the steps' own entries
find it already set.

Config: configs/train.yaml plus ``cv_dir``, ``folds`` or ``num_folds``,
``concurrent_folds``.
Usage: python -m octseg_torch.train.folds cv_dir=<abs> save_dir=<abs> [key=value ...]
"""

from __future__ import annotations

import csv
import logging
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import torch

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.infer.engine import fp32_exact
from octseg_torch.train.train import train_model

log = logging.getLogger(__name__)

SUMMARY_FIELDS = ['fold', 'best_val_loss', 'last_val_f1', 'epochs_done', 'duration_s']


def train_folds(cfg: Config) -> List[dict]:
    """Train every fold; returns ``train_model``'s summaries with ``fold``
    and ``duration_s``, in fold order."""
    cv_dir = cfg.get('cv_dir', 'data/cv')
    folds = list(cfg.get('folds') or range(1, int(cfg.get('num_folds', 5)) + 1))
    run_name = cfg.get('model_name') or f'{cfg.architecture}_{cfg.encoder}'
    save_root = os.path.join(cfg.get('save_dir', 'models'), run_name)
    os.makedirs(save_root, exist_ok=True)

    pool = octseg_torch.device_pool(cfg.get('device'))
    k = max(1, min(int(cfg.get('concurrent_folds', 1)), len(pool), len(folds)))
    # a finished fold returns its device before the next fold claims one:
    # binding devices by fold index would put two folds on one device when
    # they finish out of order
    free_devices: 'queue.Queue[torch.device]' = queue.Queue()
    for dev in pool[:k]:
        free_devices.put(dev)

    def run_one(fold) -> dict:
        fold_cfg = Config(dict(cfg))
        fold_cfg['data_dir'] = os.path.join(cv_dir, f'fold_{fold}')
        fold_cfg['model_name'] = f'{run_name}/fold_{fold}'
        t0 = time.time()
        dev = free_devices.get()
        try:
            log.info('=== fold %s (on %s) ===', fold, dev)
            summary = train_model(fold_cfg, model_dir=os.path.join(save_root, f'fold_{fold}'),
                                  device=dev)
        finally:
            free_devices.put(dev)
        summary['fold'] = fold
        summary['duration_s'] = round(time.time() - t0, 1)
        return summary

    with fp32_exact():
        if k > 1:
            with ThreadPoolExecutor(max_workers=k) as executor:
                results = list(executor.map(run_one, folds))
        else:
            results = [run_one(f) for f in folds]

    with open(os.path.join(save_root, 'folds_summary.csv'), 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=SUMMARY_FIELDS, extrasaction='ignore')
        writer.writeheader()
        writer.writerows(results)
    return results


@entry_point('train')
def main(cfg: Config) -> List[dict]:
    results = train_folds(cfg)
    log.info('Folds complete: %s', [(r['fold'], round(r['last_val_f1'], 4)) for r in results])
    return results


if __name__ == '__main__':
    main()
