"""Evaluation harness: score a trained model dir on a fold's split.

The port of octseg/train/evaluate.py: load ``weights.ckpt`` and
``config.json``, run the split in batches on the device and return per-class
rows with the reference's metric semantics (per-sample statistics averaged
over the split, dice = 2 iou / (iou + 1)) and their ``Mean``. Inputs are
ImageNet-normalised unless the manifest says ``normalize: false`` (the
training semantics, not predict's). The forward runs under ``fp32_exact``
(TF32 off). ``int8: true`` runs it under ``int8_conv_mode()`` (octseg's int8
path, ops/quantize.py); each batch has its own activation scales, so the
last, smaller batch of a split is scaled over its own frames, as in octseg.

Config: configs/evaluate.yaml.
Usage: python -m octseg_torch.train.evaluate model_dir=<abs> data_dir=<abs fold>
``device`` (default ``auto``: the GPU) may be ``cpu``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Dict, List

import numpy as np
import torch

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.infer.engine import fp32_exact, load_model_bundle
from octseg_torch.ops.normalize import normalize_imagenet, sigmoid_threshold
from octseg_torch.ops.quantize import int8_conv_mode
from octseg_torch.train.data import OCTDataset, PrefetchLoader
from octseg_torch.train.metrics import compute_metrics

log = logging.getLogger(__name__)

METRICS = ('iou', 'dice', 'precision', 'recall', 'f1')


def evaluate_model(model_dir: str, data_dir: str, batch_size: int = 8, split: str = 'test',
                   int8: bool = False, device=None) -> Dict[str, Dict[str, float]]:
    """Per-class metrics ``{class: {iou, dice, precision, recall, f1}}`` and
    their ``Mean`` over the classes."""
    device = octseg_torch.resolve_device(device)
    model, model_cfg = load_model_bundle(model_dir, device)
    classes: List[str] = model_cfg['classes']
    dataset = OCTDataset(os.path.join(data_dir, split), classes, model_cfg['input_size'])
    loader = PrefetchLoader(dataset, batch_size, shuffle=False, drop_last=False)
    normalize = bool(model_cfg.get('normalize', True))
    per_class: Dict[str, list] = {name: [] for name in METRICS}
    quantized = int8_conv_mode() if int8 else contextlib.nullcontext()
    with torch.inference_mode(), fp32_exact(), quantized:
        for imgs, masks in loader:
            x = torch.from_numpy(imgs).to(device)
            if normalize:
                x = normalize_imagenet(x)
            logits = model(x.permute(0, 3, 1, 2).contiguous())
            target = torch.from_numpy(masks).to(device).permute(0, 3, 1, 2)
            m = compute_metrics(sigmoid_threshold(logits), target, torch.zeros(()))
            for name in per_class:
                per_class[name].append(m[name].cpu().numpy())   # (N, C)

    stacked = {k: np.concatenate(v, axis=0) for k, v in per_class.items()}
    out: Dict[str, Dict[str, float]] = {
        cl: {k: float(stacked[k][:, ci].mean()) for k in per_class}
        for ci, cl in enumerate(classes)}
    out['Mean'] = {k: float(np.mean([out[cl][k] for cl in classes])) for k in per_class}
    return out


@entry_point('evaluate')
def main(cfg: Config) -> Dict[str, Dict[str, float]]:
    model_dir = octseg_torch.project_path(cfg.model_dir)
    split = cfg.get('split', 'test')
    results = evaluate_model(model_dir, octseg_torch.project_path(cfg.data_dir),
                             int(cfg.get('batch_size', 8)), split,
                             int8=bool(cfg.get('int8', False)), device=cfg.get('device', 'auto'))
    for cl, metrics in results.items():
        log.info('%-14s DSC %.4f  IoU %.4f  Precision %.4f  Recall %.4f  F1 %.4f',
                 cl, metrics['dice'], metrics['iou'], metrics['precision'],
                 metrics['recall'], metrics['f1'])
    save_path = os.path.join(model_dir, f'eval_{split}.json')
    with open(save_path, 'w') as f:
        json.dump(results, f, indent=2)
    log.info('Saved %s', save_path)
    return results


if __name__ == '__main__':
    main()
