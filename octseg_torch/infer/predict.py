"""Hybrid ensemble prediction entry point.

The port of octseg/infer/predict.py. ``data_dir`` may be:

- a DICOM pullback (native or JPEG Baseline/Extended pixel data): frames
  stream through ``InferenceEngine.iter_pullback`` block by block and each
  frame gets the reference's ``{base}_{i}_overlay.png`` and ``_mask.png``;
- a directory of PNG and JPEG images, or one image file (the reference's
  path, configs/predict.yaml's default): ``data_processing`` reads and
  resizes them, ``InferenceEngine.segment`` fills their masks and
  ``save_results`` writes ``{name}_overlay.png`` and ``{name}_mask.png``.

``bf16: true`` runs the models with bfloat16 compute; ``int8: true`` runs
their eligible convolutions in int8 (ops/quantize.py), with activation
scales that span each chunk of frames.

Config: configs/predict.yaml (the reference's keys).
Usage: python -m octseg_torch.infer.predict data_dir=<pullback.dcm or image dir> \\
    models_dir=... save_dir=... output_size=[1000,1000]
``device`` (default ``auto``: the GPU) may be ``cpu``.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.data import dicom
from octseg_torch.data.image import normalize_slice, pil_resize_bicubic
from octseg_torch.data.utils import data_processing, save_results
from octseg_torch.infer.engine import InferenceEngine

log = logging.getLogger(__name__)

def _is_dicom(path: str) -> bool:
    if not os.path.isfile(path):
        return False
    with open(path, 'rb') as f:
        head = f.read(132)
    return len(head) >= 132 and head[128:132] == b'DICM'


def load_pullback_frames(dcm_path: str) -> np.ndarray:
    """DICOM pullback -> (N, H, W, C) uint8 frames (C = 1 mono / 3 RGB).
    Non-uint8 data is min-max normalized per slice, as the data-prep chain
    normalized every training frame."""
    frames = dicom.dcmread(dcm_path).pixel_array
    if frames.dtype != np.uint8:
        frames = np.stack([normalize_slice(f) for f in frames])
    if frames.ndim == 3:
        frames = frames[..., None]
    return frames


def _rgb(frame: np.ndarray) -> np.ndarray:
    return np.repeat(frame, 3, axis=-1) if frame.shape[-1] == 1 else frame


def render_mask_block(frames: np.ndarray, block_masks: np.ndarray, start: int,
                      out_size, classes, save_dir: str, base: str, width: int,
                      device=None) -> None:
    """Write ``{base}_{i}_overlay.png`` + ``_mask.png`` for one block of
    masks; frames are resized as PIL's default RGB resize does, on a thread
    pool (numpy releases the interpreter lock). The postprocess runs on
    ``device`` (default: the GPU, see ``octseg_torch.resolve_device``)."""
    out_h, out_w = int(out_size[0]), int(out_size[1])
    n = block_masks.shape[0]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        images = list(pool.map(
            lambda j: pil_resize_bicubic(_rgb(frames[start + j]), (out_w, out_h)), range(n)))
    names = [f'{base}_{start + j + 1:0{width}d}' for j in range(n)]
    save_results(images=images, masks=block_masks, images_name=names,
                 classes=list(classes), save_dir=save_dir, device=device)


def _predict_dicom(cfg: Config, dcm_path: str, engine: InferenceEngine,
                   save_dir: str) -> Tuple[int, Dict[str, float]]:
    """Stream a DICOM pullback through the engine and write the PNGs.
    Returns the frame count and the wall seconds per stage: decode, engine
    (the host waiting for each block's masks: forward and bit expansion),
    render (resize, postprocess, compositing, PNG encoding)."""
    t = time.perf_counter()
    frames = load_pullback_frames(dcm_path)
    seconds = {'decode': time.perf_counter() - t, 'engine': 0.0, 'render': 0.0}
    base = os.path.splitext(os.path.basename(dcm_path))[0]
    width = len(str(frames.shape[0]))
    blocks = engine.iter_pullback(frames, cfg.output_size)
    while True:
        t = time.perf_counter()
        item = next(blocks, None)
        seconds['engine'] += time.perf_counter() - t
        if item is None:
            break
        t = time.perf_counter()
        start, block_masks = item
        render_mask_block(frames, block_masks, start, cfg.output_size, cfg.classes,
                          save_dir, base, width, device=engine.device)
        seconds['render'] += time.perf_counter() - t
    return int(frames.shape[0]), seconds


def _predict_images(cfg: Config, data_dir: str, engine: InferenceEngine,
                    save_dir: str) -> Tuple[int, Dict[str, float]]:
    """The image path: read and resize the images, segment them, write the
    PNGs. Returns the image count and the wall seconds per stage: decode
    (reading, decoding and resizing to the output size), engine (host
    preprocessing to each model's input size, forwards, bit expansion),
    render (postprocess, compositing, PNG encoding)."""
    t = time.perf_counter()
    images, masks, names = data_processing(data_dir, save_dir, cfg.output_size)
    seconds = {'decode': time.perf_counter() - t}
    log.info('Number of images: %d', len(names))
    t = time.perf_counter()
    masks = engine.segment(images, masks, cfg.output_size)
    seconds['engine'] = time.perf_counter() - t
    t = time.perf_counter()
    save_results(images=[img.to_rgb() for img in images], masks=masks, images_name=names,
                 classes=list(cfg.classes), save_dir=save_dir, device=engine.device)
    seconds['render'] = time.perf_counter() - t
    return len(names), seconds


@entry_point('predict')
def main(cfg: Config) -> Dict[str, object]:
    """Run the predict path for a DICOM pullback or an image directory;
    returns ``{'frames': n, 'seconds': {stage: s}, 'chunks': {model dir:
    frames per forward}}``."""
    data_dir, models_dir, save_dir = (octseg_torch.project_path(cfg.data_dir),
                                      octseg_torch.project_path(cfg.models_dir),
                                      octseg_torch.project_path(cfg.save_dir))
    start = time.perf_counter()
    engine = InferenceEngine(
        models_dir=models_dir, classes=list(cfg.classes),
        block_size=int(cfg.get('block_size', 128)),
        output_resize=str(cfg.get('output_resize', 'prob_bilinear')),
        device=cfg.get('device', 'auto'), bf16=bool(cfg.get('bf16', False)),
        int8=bool(cfg.get('int8', False)))
    pullback = _is_dicom(data_dir)
    if pullback:
        os.makedirs(save_dir, exist_ok=True)
        n, seconds = _predict_dicom(cfg, data_dir, engine, save_dir)
    else:
        n, seconds = _predict_images(cfg, data_dir, engine, save_dir)
    seconds['total'] = time.perf_counter() - start
    log.info('%s: %d', 'Pullback frames' if pullback else 'Images', n)
    log.info('Seconds per stage: %s', {k: round(v, 3) for k, v in seconds.items()})
    log.info('Complete')
    chunks = {key[0]: plan.chunk for key, plan in engine.chunk_plans.items()}
    return {'frames': n, 'seconds': seconds, 'chunks': chunks}


if __name__ == '__main__':
    main()
