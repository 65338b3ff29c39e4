"""Batch CAM driver: per image x class heatmaps, overlays and CAM-vs-GT
scores (the port of octseg/explain/visualize_activation_maps.py).

Loads one model dir, and for each image of ``{data_dir}/img`` and each
selected class predicts the mask, extracts the activation map, overlays it,
binarizes it at ``map_threshold`` and scores it against the ground-truth
mask (micro dice, IoU, precision, recall). Per pair it writes the source,
ground truth, prediction, map and overlay PNGs, and ``metrics.csv`` per
method. cv2's reads, resizes and writes are the port's: ``read_png``,
``resize_linear_u8``, ``resize_nearest_u8`` and ``write_png``.

Config: configs/visualize_activation_maps.yaml.
Usage: python -m octseg_torch.explain.visualize_activation_maps [key=value ...];
``device=cpu`` off the card.
"""

from __future__ import annotations

import csv
import logging
import os
from glob import glob
from pathlib import Path

import numpy as np
import torch

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.data.image import read_png, resize_linear_u8, resize_nearest_u8, write_png
from octseg_torch.data.tiffio import read_tiff
from octseg_torch.explain.cam import CAMProcessor
from octseg_torch.infer.engine import fp32_exact, load_model_bundle
from octseg_torch.ops.normalize import normalize_imagenet

log = logging.getLogger(__name__)


def micro_scores(pred: np.ndarray, gt: np.ndarray) -> dict:
    pred = pred.astype(bool).ravel()
    gt = gt.astype(bool).ravel()
    tp = float(np.sum(pred & gt))
    fp = float(np.sum(pred & ~gt))
    fn = float(np.sum(~pred & gt))
    eps = 1e-7
    return {
        'dice': 2 * tp / max(2 * tp + fp + fn, eps),
        'iou': tp / max(tp + fp + fn, eps),
        'precision': tp / max(tp + fp, eps),
        'recall': tp / max(tp + fn, eps),
    }


@entry_point('visualize_activation_maps')
def main(cfg: Config) -> list:
    device = octseg_torch.resolve_device(cfg.get('device'))
    model, model_cfg = load_model_bundle(cfg.model_dir, device)
    classes = list(cfg.get('classes') or model_cfg['classes'])
    input_size = model_cfg['input_size']
    method = cfg.get('cam_method', 'GradCAM')
    threshold = float(cfg.get('map_threshold', 0.5))
    save_dir = os.path.join(cfg.save_dir, method)
    os.makedirs(save_dir, exist_ok=True)

    level = cfg.get('feature_level')
    processor = CAMProcessor(model, method=method,
                             feature_level=int(level) if level is not None else None)
    # octseg-trained manifests declare normalize=true (training applies
    # ImageNet mean/std); converted reference checkpoints lack the key and
    # take raw BGR floats, as the inference engine does
    normalize = bool(model_cfg.get('normalize', False))

    rows = []
    img_paths = sorted(glob(os.path.join(cfg.data_dir, 'img', '*.[pj][np]g')))
    with fp32_exact():
        for img_path in img_paths:
            stem = Path(img_path).stem
            img_bgr = resize_linear_u8(read_png(img_path), (input_size, input_size))
            gt = read_tiff(os.path.join(cfg.data_dir, 'mask', f'{stem}.tiff'))
            gt = resize_nearest_u8(gt, (input_size, input_size))
            if gt.ndim == 2:
                gt = gt[:, :, None]
            x = img_bgr.astype(np.float32)
            if normalize:
                x = normalize_imagenet(torch.from_numpy(x)).numpy()
            with torch.no_grad():
                logits = model(torch.from_numpy(x.transpose(2, 0, 1)[None]).to(device))
            logits = logits[0].permute(1, 2, 0).cpu().numpy()
            pred = (1 / (1 + np.exp(-logits)) > 0.5).astype(np.float32)

            for ch, class_name in enumerate(model_cfg['classes']):
                if class_name not in classes:
                    continue
                # GT channel: class_id - 1, unless the mask holds only the
                # model's own channels
                cid = CLASS_IDS[class_name] - 1
                if gt.shape[2] <= cid:
                    if gt.shape[2] == len(model_cfg['classes']):
                        cid = ch
                    else:
                        raise ValueError(
                            f'{stem}: GT mask has {gt.shape[2]} channels — cannot '
                            f'locate class {class_name!r} (id {cid + 1})')
                gt_mask = (gt[:, :, cid] > 0).astype(np.float32)
                pred_mask = pred[:, :, ch]
                cam = processor.extract_activation_map(x, category=ch, mask=pred_mask)
                overlay = processor.overlay_activation_map(img_bgr[..., ::-1], cam)
                cam_bin = (cam >= threshold).astype(np.float32)
                scores = micro_scores(cam_bin, gt_mask)
                rows.append({'image': stem, 'class': class_name, 'method': method,
                             **{k: round(v, 4) for k, v in scores.items()}})

                tag = f'{stem}_{class_name.replace(" ", "_")}'
                # the PNGs hold what octseg's cv2.imwrite writes: RGB
                write_png(f'{save_dir}/{tag}_source.png',
                          np.ascontiguousarray(img_bgr[..., ::-1]))
                write_png(f'{save_dir}/{tag}_gt.png', (gt_mask * 255).astype(np.uint8))
                write_png(f'{save_dir}/{tag}_pred.png', (pred_mask * 255).astype(np.uint8))
                write_png(f'{save_dir}/{tag}_map.png', (cam * 255).astype(np.uint8))
                write_png(f'{save_dir}/{tag}_overlay.png', overlay)
            log.info('Processed %s', stem)

    if rows:
        with open(os.path.join(save_dir, 'metrics.csv'), 'w', newline='') as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    log.info('Complete')
    return rows


if __name__ == '__main__':
    main()
