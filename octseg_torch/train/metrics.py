"""Multilabel segmentation metrics and the metrics.csv contract (the port of
octseg/train/metrics.py).

Device part: per-sample, per-class tp/fp/fn/tn and the scores smp.metrics
computes for the reference (reduction None, zero_division eps, and its
dice quirk dice = 2 iou / (iou + 1)), from NCHW masks.

Host part: epoch aggregation and the append-only CSV with the fixed schema
(Epoch,Loss,IoU,Dice,Precision,Recall,F1,Split,Class), per-class rows then
a Mean row, as the JAX package writes it.
"""

from __future__ import annotations

import os
from csv import DictWriter
from typing import Dict, List, Optional

import numpy as np
import torch

EPS = 1e-7
CSV_FIELDS = ['Epoch', 'Loss', 'IoU', 'Dice', 'Precision', 'Recall', 'F1', 'Split', 'Class']


def multilabel_stats(pred: torch.Tensor, target: torch.Tensor):
    """tp/fp/fn/tn per (sample, class) for binary {0,1} NCHW masks."""
    pred = pred.float()
    target = target.float()
    tp = torch.sum(pred * target, dim=(2, 3))
    fp = torch.sum(pred * (1 - target), dim=(2, 3))
    fn = torch.sum((1 - pred) * target, dim=(2, 3))
    tn = torch.sum((1 - pred) * (1 - target), dim=(2, 3))
    return tp, fp, fn, tn


def _safe_div(num: torch.Tensor, den: torch.Tensor, zero_division: float = EPS) -> torch.Tensor:
    return torch.where(den == 0, zero_division, num / torch.where(den == 0, 1.0, den))


def compute_metrics(pred: torch.Tensor, target: torch.Tensor, loss: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Batch metrics: each entry (N, C) except ``loss`` (a scalar)."""
    tp, fp, fn, _tn = multilabel_stats(pred, target)
    iou = _safe_div(tp, tp + fp + fn)
    return {
        'loss': loss,
        'iou': iou,
        'dice': 2 * iou / (iou + 1),  # the reference's quirk
        'recall': _safe_div(tp, tp + fn),
        'precision': _safe_div(tp, tp + fp),
        'f1': _safe_div(2 * tp, 2 * tp + fp + fn),
    }


def aggregate_epoch(metrics_epoch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Mean over batches of per-batch sample means (the loss is a scalar
    per batch)."""
    out: Dict[str, np.ndarray] = {}
    for name in metrics_epoch[0].keys():
        per_batch = []
        for batch in metrics_epoch:
            v = np.asarray(batch[name])
            per_batch.append(v if v.size == 1 else v.mean(axis=0))
        out[name] = np.mean(np.stack([np.squeeze(b) for b in per_batch]), axis=0) \
            if per_batch[0].size == 1 else np.mean(np.stack(per_batch, axis=0), axis=0)
    return out


def save_metrics_on_epoch(metrics_epoch: List[Dict[str, np.ndarray]], split: str,
                          model_dir: str, classes: List[str], epoch: int,
                          best_metrics: Optional[dict] = None, logger=None) -> Optional[dict]:
    """Append per-class + Mean rows to {model_dir}/metrics.csv and track best
    metrics. Returns the updated best_metrics."""
    metrics = aggregate_epoch(metrics_epoch)
    csv_path = os.path.join(model_dir, 'metrics.csv')
    write_header = not os.path.exists(csv_path)
    os.makedirs(model_dir, exist_ok=True)

    metrics_log = {
        f'{split}/loss': float(np.asarray(metrics['loss'])),
        f'{split}/iou': float(np.asarray(metrics['iou']).mean()),
        f'{split}/dice': float(np.asarray(metrics['dice']).mean()),
        f'{split}/precision': float(np.asarray(metrics['precision']).mean()),
        f'{split}/recall': float(np.asarray(metrics['recall']).mean()),
        f'{split}/f1': float(np.asarray(metrics['f1']).mean()),
    }
    if best_metrics is not None:
        for name in ['iou', 'dice', 'precision', 'recall']:
            value = metrics_log[f'{split}/{name}']
            if name not in best_metrics or value > best_metrics[name]['value']:
                best_metrics[name] = {'value': value, 'epoch': epoch}
    if logger is not None:
        logger.log_scalars(metrics_log, step=epoch)

    def _per_class(name: str, idx: int) -> float:
        v = np.asarray(metrics[name])
        return float(v[idx]) if v.ndim else float(v)

    loss = float(np.asarray(metrics['loss']))
    with open(csv_path, 'a', newline='') as f:
        writer = DictWriter(f, fieldnames=CSV_FIELDS)
        if write_header:
            writer.writeheader()
        for num, cl in enumerate(classes):
            writer.writerow({'Epoch': epoch, 'Loss': loss, 'IoU': _per_class('iou', num),
                             'Dice': _per_class('dice', num),
                             'Precision': _per_class('precision', num),
                             'Recall': _per_class('recall', num), 'F1': _per_class('f1', num),
                             'Split': split, 'Class': cl})
        writer.writerow({'Epoch': epoch, 'Loss': loss,
                         'IoU': float(np.asarray(metrics['iou']).mean()),
                         'Dice': float(np.asarray(metrics['dice']).mean()),
                         'Precision': float(np.asarray(metrics['precision']).mean()),
                         'Recall': float(np.asarray(metrics['recall']).mean()),
                         'F1': float(np.asarray(metrics['f1']).mean()),
                         'Split': split, 'Class': 'Mean'})
    return best_metrics
