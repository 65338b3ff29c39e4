"""Training entry point (the port of octseg/train/train.py).

One device. A step: the host loader's batch (NHWC float32) -> K2
augmentation on the device (``ops/augment.augment_batch``) -> ImageNet
normalisation -> forward and backward (cuDNN in full float32, TF32 off) ->
the optax-formula optimizer (``train/state.py``) -> metrics, kept on the
device until the epoch ends. Each epoch appends to ``metrics.csv`` and
``scalars.jsonl``, writes ``weights.ckpt`` when the validation loss
improves, ``resume.ckpt`` every ``resume_interval`` epochs, and the
tri-panel examples of ``{data_dir}/vis`` to ``images_per_epoch/``.

``bf16: true`` builds the model with bfloat16 compute (float32 parameters,
optimizer state, BatchNorm statistics and loss; models/common.py) and
``remat: true`` checkpoints its blocks (models/remat.py), as octseg's keys
do. Not ported: the JAX package's device mesh and its native C++ loader
(ROADMAP.md, "Opt-in, last"); ``native_loader: true`` raises
NotImplementedError.

Config: configs/train.yaml (the reference's keys).
Usage: python -m octseg_torch.train.train data_dir=<fold> save_dir=<dir>
``device`` (default ``auto``: the GPU) may be ``cpu``.
"""

from __future__ import annotations

import logging
import math
import os
import time
from glob import glob
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.logging_utils import ScalarLogger
from octseg_torch.core.registry import CLASS_COLORS_BGR, CLASS_IDS
from octseg_torch.data.image import read_png, resize_linear_u8, resize_nearest_u8, write_png
from octseg_torch.data.tiffio import read_tiff
from octseg_torch.infer.engine import fp32_exact
from octseg_torch.models import create_model
from octseg_torch.models.common import set_dropout_generator
from octseg_torch.ops.augment import augment_batch
from octseg_torch.ops.normalize import normalize_imagenet, sigmoid_threshold
from octseg_torch.train import checkpoint as ckpt
from octseg_torch.train.data import OCTDataset, PrefetchLoader
from octseg_torch.train.losses import dice_loss_from_logits
from octseg_torch.train.metrics import compute_metrics, save_metrics_on_epoch
from octseg_torch.train.state import TrainState, make_optimizer

log = logging.getLogger(__name__)

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def init_model(model: nn.Module, seed: int) -> nn.Module:
    """Flax's initialization of octseg's models, drawn from
    ``torch.Generator().manual_seed(seed)``: conv and transposed-conv
    kernels lecun-normal (truncated normal, variance 1/fan_in, fan_in =
    ``weight[0].numel()``, see checkpoint.initialize_model_dir), conv biases
    0, BatchNorm at its identity. The draws differ from jax.random's."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def _loss_and_logits(model: nn.Module, imgs: torch.Tensor, masks: torch.Tensor):
    """(loss, logits NCHW, targets NCHW) for NHWC images and masks."""
    x = normalize_imagenet(imgs).permute(0, 3, 1, 2).contiguous()
    logits = model(x)
    targets = masks.permute(0, 3, 1, 2)
    return dice_loss_from_logits(logits, targets), logits, targets


def make_train_step(use_augmentation: bool) -> Callable:
    """``train_step(state, imgs, masks, generator) -> metrics`` (device
    tensors): augment, forward, backward and one optimizer update. The
    augmentation draws from ``generator`` first, then the model's dropout
    (FPN, PSPNet, DeepLab), as octseg splits its step key into both."""

    def train_step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        if use_augmentation:
            imgs, masks = augment_batch(imgs, masks, generator)
        set_dropout_generator(state.model, generator)
        state.model.train()
        with fp32_exact():
            loss, logits, targets = _loss_and_logits(state.model, imgs, masks)
            loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            return compute_metrics(sigmoid_threshold(logits.detach()), targets, loss.detach())

    return train_step


def make_eval_step() -> Callable:
    """``eval_step(state, imgs, masks) -> metrics`` with running statistics."""

    def eval_step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        state.model.eval()
        with torch.no_grad(), fp32_exact():
            loss, logits, targets = _loss_and_logits(state.model, imgs, masks)
            return compute_metrics(sigmoid_threshold(logits), targets, loss)

    return eval_step


def dump_epoch_examples(cfg: Config, model: nn.Module, model_dir: str, classes: List[str],
                        epoch: int, device: torch.device) -> None:
    """Tri-panel PNGs (image | ground-truth colours | predicted colours) of
    {data_dir}/vis/img, normalized as the train and eval steps are."""
    vis_dir = os.path.join(cfg.data_dir, 'vis', 'img')
    if not os.path.isdir(vis_dir):
        return
    out_dir = os.path.join(model_dir, 'images_per_epoch')
    os.makedirs(out_dir, exist_ok=True)
    size = int(cfg.input_size)
    model.eval()
    for img_path in glob(os.path.join(vis_dir, '*.[pj][np]g')):
        img = resize_linear_u8(read_png(img_path), (size, size))
        mask_path = os.path.splitext(img_path.replace('/img/', '/mask/'))[0] + '.tiff'
        if not os.path.exists(mask_path):
            continue
        gt = resize_nearest_u8(read_tiff(mask_path), (size, size))
        if gt.ndim == 2:
            gt = gt[:, :, None]
        x = normalize_imagenet(torch.from_numpy(img[None]).float().to(device))
        with torch.no_grad(), fp32_exact():
            logits = model(x.permute(0, 3, 1, 2).contiguous())
        pred = (logits[0] > 0).permute(1, 2, 0).cpu().numpy()
        panel_gt = np.full_like(img, 128)
        panel_pred = np.full_like(img, 128)
        for idy, cl in enumerate(classes):
            panel_gt[gt[:, :, CLASS_IDS[cl] - 1] == 255] = CLASS_COLORS_BGR[cl]
            panel_pred[pred[:, :, idy]] = CLASS_COLORS_BGR[cl]
        res = np.hstack([img, panel_gt, panel_pred])
        stem = os.path.splitext(os.path.basename(img_path))[0]
        # the panels are BGR, as cv2.imwrite takes them; the PNG holds RGB
        write_png(os.path.join(out_dir, f'{stem}_epoch_{epoch:03d}.png'),
                  np.ascontiguousarray(res[..., ::-1]))


def _fetch(metrics: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """Host copies of a split's per-batch metrics in one transfer (the last
    batch of a split may be smaller)."""
    if not metrics:
        return []
    flat = torch.cat([t.reshape(-1) for m in metrics for t in m.values()]).cpu().numpy()
    out, pos = [], 0
    for m in metrics:
        host = {}
        for k, t in m.items():
            host[k] = flat[pos:pos + t.numel()].reshape(tuple(t.shape))
            pos += t.numel()
        out.append(host)
    return out


def _step_seed(seed: int, epoch: int, step: int) -> int:
    """The augmentation generator's seed for one step, so that a resumed run
    draws what an uninterrupted one would."""
    return int(seed) * 1_000_003 + epoch * 100_003 + step


def train_model(cfg: Config, model_dir: Optional[str] = None,
                on_epoch_end: Optional[Callable[[int, dict], bool]] = None,
                device=None) -> dict:
    """Run one training; returns the summary (best metrics, epochs done, and
    the seconds spent per stage).

    on_epoch_end(epoch, summary) -> bool: return True to stop early.
    device: None reads ``cfg.device`` (``auto``: the GPU, raising without
    one); ``'cpu'`` runs on the CPU."""
    device = octseg_torch.resolve_device(device if device is not None else cfg.get('device'))
    if cfg.get('native_loader', 'auto') is True:
        raise NotImplementedError('native_loader: true is not ported: the native C++ loader '
                                  'is ROADMAP.md, "Opt-in, last"; use auto or false')
    classes = list(cfg.classes)
    model_name = cfg.get('model_name') or f'{cfg.architecture}_{cfg.encoder}'
    model_dir = model_dir or os.path.join(cfg.get('save_dir', 'models'), model_name)
    os.makedirs(model_dir, exist_ok=True)
    ckpt.save_manifest(model_dir, cfg, model_name)

    train_set = OCTDataset(os.path.join(cfg.data_dir, 'train'), classes, cfg.input_size)
    val_set = OCTDataset(os.path.join(cfg.data_dir, 'test'), classes, cfg.input_size)
    seed = int(cfg.get('seed', 11))
    log.info('Training on %s', device)

    dtype = torch.bfloat16 if cfg.get('bf16', False) else torch.float32
    model = init_model(create_model(cfg.architecture, cfg.encoder, classes=len(classes),
                                    dtype=dtype, remat=bool(cfg.get('remat', False))), seed)
    enc_weights = cfg.get('encoder_weights')
    if enc_weights and str(enc_weights).lower() not in ('none', 'null', ''):
        ckpt.load_pretrained_encoder(model, str(enc_weights))
        log.info('Initialized encoder from %s', enc_weights)
    init_w = cfg.get('init_weights')
    if init_w and str(init_w).lower() not in ('none', 'null', ''):
        ckpt.restore_weights_into(model, str(init_w), cfg.architecture, cfg.encoder)
        log.info('Warm-started params+batch_stats from %s', init_w)
    model.to(device)
    state = TrainState.create(model, make_optimizer(cfg.optimizer, cfg.lr,
                                                    cfg.get('weight_decay', 0.0)))
    train_step = make_train_step(bool(cfg.get('use_augmentation', False)))
    eval_step = make_eval_step()
    generator = torch.Generator(device=device)

    train_loader = PrefetchLoader(train_set, cfg.batch_size, shuffle=True, drop_last=True,
                                  seed=seed)
    val_loader = PrefetchLoader(val_set, cfg.batch_size, shuffle=False, drop_last=False)
    if len(train_loader) == 0:
        raise ValueError(
            f'train split has {len(train_set)} samples — smaller than '
            f'batch_size {cfg.batch_size} (drop_last): nothing to train on')

    start_epoch = 1
    best_val_loss = float('inf')
    best_metrics: dict = {}
    summary: dict = {}
    resume_path = os.path.join(model_dir, 'resume.ckpt')
    if cfg.get('resume', False) and os.path.exists(resume_path):
        state, last_epoch, extra = ckpt.load_resume(resume_path, state)
        start_epoch = last_epoch + 1
        best_val_loss = extra.get('best_val_loss', float('inf'))
        best_metrics = dict(extra.get('best_metrics', {}))
        # the loaders draw permutation rng(seed + epoch) per pass
        train_loader.epoch = last_epoch
        summary = {'best_val_loss': best_val_loss,
                   'last_val_f1': float(extra.get('last_val_f1', 0.0)),
                   'best_metrics': best_metrics, 'epochs_done': last_epoch}
        log.info('Resumed from %s at epoch %d', resume_path, last_epoch)

    seconds = dict.fromkeys(('data_wait', 'train', 'eval', 'images', 'checkpoint'), 0.0)
    steps = 0
    scalar_logger = ScalarLogger(model_dir)
    for epoch in range(start_epoch, int(cfg.epochs) + 1):
        t0 = time.time()
        device_metrics = []
        batches = iter(train_loader)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            seconds['data_wait'] += t1 - t
            if batch is None:
                break
            generator.manual_seed(_step_seed(seed, epoch, len(device_metrics)))
            device_metrics.append(train_step(state, torch.from_numpy(batch[0]).to(device),
                                             torch.from_numpy(batch[1]).to(device), generator))
            seconds['train'] += time.perf_counter() - t1
        steps += len(device_metrics)
        t = time.perf_counter()
        train_metrics = _fetch(device_metrics)   # waits for the epoch's steps
        seconds['train'] += time.perf_counter() - t
        losses = np.array([m['loss'] for m in train_metrics])
        if cfg.get('check_finite', True) and not np.all(np.isfinite(losses)):
            bad = int(np.argmax(~np.isfinite(losses)))
            raise FloatingPointError(f'Non-finite loss at epoch {epoch} step {bad}')
        save_metrics_on_epoch(train_metrics, 'train', model_dir, classes, epoch,
                              logger=scalar_logger)

        t = time.perf_counter()
        val_metrics = _fetch([eval_step(state, torch.from_numpy(imgs).to(device),
                                        torch.from_numpy(masks).to(device))
                              for imgs, masks in val_loader])
        seconds['eval'] += time.perf_counter() - t
        best_metrics = save_metrics_on_epoch(val_metrics, 'test', model_dir, classes, epoch,
                                             best_metrics, logger=scalar_logger)
        interval = cfg.get('img_save_interval')
        if interval and epoch % int(interval) == 0:
            t = time.perf_counter()
            dump_epoch_examples(cfg, state.model, model_dir, classes, epoch, device)
            seconds['images'] += time.perf_counter() - t

        val_loss = float(np.mean([m['loss'] for m in val_metrics]))
        val_f1 = float(np.mean([m['f1'].mean() for m in val_metrics]))
        log.info('epoch %d  val/loss %.4f  val/f1 %.4f  (%.1f s)', epoch, val_loss, val_f1,
                 time.time() - t0)
        t = time.perf_counter()
        if val_loss < best_val_loss:  # ModelCheckpoint(val/loss, min) parity
            best_val_loss = val_loss
            ckpt.save_model_weights(os.path.join(model_dir, 'weights.ckpt'), state.model,
                                    cfg.architecture, cfg.encoder)
        interval = max(1, int(cfg.get('resume_interval', 1)))
        if epoch % interval == 0 or epoch == int(cfg.epochs):
            ckpt.save_resume(resume_path, state, epoch,
                             {'best_val_loss': best_val_loss, 'best_metrics': best_metrics,
                              'last_val_f1': val_f1})
        seconds['checkpoint'] += time.perf_counter() - t
        summary = {'best_val_loss': best_val_loss, 'last_val_f1': val_f1,
                   'best_metrics': best_metrics, 'epochs_done': epoch}
        if on_epoch_end is not None and on_epoch_end(epoch, summary):
            log.info('Early termination requested at epoch %d', epoch)
            break
    summary.update(model_dir=model_dir, seconds=seconds, train_steps=steps,
                   train_samples=steps * int(cfg.batch_size))
    return summary


@entry_point('train')
def main(cfg: Config) -> dict:
    t = time.strftime('%d%m_%H%M')
    cfg['model_name'] = f'{cfg.architecture}_{cfg.encoder}_{t}'  # the reference's name
    summary = train_model(cfg)
    log.info('Complete: %s', {k: v for k, v in summary.items() if k != 'seconds'})
    return summary


if __name__ == '__main__':
    main()
