#!/usr/bin/env python3
"""Smoke run of octseg_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)

Phases, each raising on failure (exit code != 0):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the port's CUDA kernels with nvcc, one process per source, all
     started together;
  3. K1, the fused overlay postprocess kernel, against its plain torch
     version on the card (ring bit-exact, fill within 1e-5) at the predict
     path's shape and at test shapes, timed with CUDA events beside the
     plain version and the card's bound;
  4. K2, the augmentation warp kernel, against its plain torch version
     (masks bit-exact, images within 1e-4 on 0..255) at the training
     path's shape (4, 512, 512) with every geometric branch on, six 32 px
     maps and a non-square frame, timed beside the plain version, the bound
     and F.grid_sample (a yardstick the port never calls);
  5. the predict path at full width: a UnetPlusPlus/resnet101 Lumen model
     dir at 512 px (random weights from a seed), a 32-frame 704x704
     grayscale DICOM pullback, ``octseg_torch.infer.predict.main`` with
     configs/predict.yaml's block size to 1000x1000 overlay PNGs; K1 must
     launch;
  5b. the device memory peak of one full block (predict.yaml's
     ``block_size`` frames) through the engine;
  6. ensemble routing with three Unet/resnet18 model dirs at 64 px over all
     four classes, GPU against CPU;
  7. the Lumen model's logits on 2 frames, GPU (TF32 off) against CPU;
  8. the training path at full width: a synthetic fold of 1000 px frames
     (16 train, 4 test, 2 vis), ``octseg_torch.train.train.main`` for two
     epochs with every other key from configs/train.yaml (Unet/resnet50 at
     512, batch 4, four classes, Adam, augmentation on); K2 must launch once
     per training step; then one step at those shapes timed alone and
     profiled (device busy time by kernel, idle share);
  9. Unet/resnet18 at 64 px, GPU (TF32 off) against CPU, from the same
     weights: the first step's gradients, three SGD steps and three Adam
     steps, with controls that must fail;
 10. one JSON line of kernels; last, the result line.

Everything is written under a temporary directory that is removed at the
end. Logs go to stderr; stdout carries the card line, the kernels line and
the result line, which is last.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
K1_BYTES_PER_PIXEL = 12       # 4 B mask read, 4 B fill + 4 B ring written
K1_OPS_PER_PIXEL = 118        # 2x16 + 2x32 max, 3 complements, 1 product, 2x9 blur
MAIN_FRAMES, MAIN_FRAME_PX, MAIN_OUT = 32, 704, 1000
K2_OPS_PER_PIXEL = 60         # coordinates 15, per channel 7 blend or 1 select
TRAIN_FRAME_PX = 1000         # the dataset's frames (configs/convert_sly_to_int.yaml)
TRAIN_SPLITS = (16, 4, 2)     # train, test, vis samples of the synthetic fold


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()

    def run(self, name, fn, *args):
        t = time.perf_counter()
        log(f'== {name}')
        out = fn(*args)
        log(f'== {name}: {time.perf_counter() - t:.1f} s '
            f'(elapsed {time.perf_counter() - self.t0:.1f} s)')
        return out


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def blob_masks(torch, m: int, h: int, w: int, seed: int):
    """(m, h, w) float32 {0,1} masks of 1-3 random discs each, on the card."""
    gen = torch.Generator().manual_seed(seed)
    yy = torch.arange(h, device='cuda').view(h, 1)
    xx = torch.arange(w, device='cuda').view(1, w)
    out = torch.zeros((m, h, w), device='cuda')
    for i in range(m):
        for _ in range(int(torch.randint(1, 4, (1,), generator=gen))):
            cy = int(torch.randint(0, h, (1,), generator=gen))
            cx = int(torch.randint(0, w, (1,), generator=gen))
            r = int(torch.randint(3, max(h, w) // 4, (1,), generator=gen))
            out[i] = torch.maximum(
                out[i], (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r).float())
    return out


def border_masks(torch):
    masks = torch.zeros((1, 64, 200), device='cuda')
    masks[0, :10, :10] = 1
    masks[0, -8:, -12:] = 1
    masks[0, 30:40, 0:5] = 1
    masks[0, 0:5, 100:140] = 1
    return masks


def time_ms(torch, fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_k1(torch):
    """Kernel vs plain chain on the card; returns the timing record."""
    from octseg_torch.ops.kernels import postprocess as k1

    cases = {
        'main path': blob_masks(torch, MAIN_FRAMES, MAIN_OUT, MAIN_OUT, 1),
        '64x1000x1000': blob_masks(torch, 64, 1000, 1000, 2),
        '3x130x250': blob_masks(torch, 3, 130, 250, 3),
        'border 1x64x200': border_masks(torch),
    }
    max_abs_err, ring_exact = 0.0, True
    for name, masks in cases.items():
        fill, ring = k1.fused_overlay_postprocess(masks)
        torch.cuda.synchronize()
        pfill, pring = k1.postprocess_chain(masks)
        err = float((fill - pfill).abs().max())
        exact = bool(torch.equal(ring, pring))
        log(f'K1 {name}: fill max |err| {err:.3g}, ring exact {exact}, '
            f'ring px {int(ring.sum())}, fill sum {float(fill.sum()):.1f}')
        if err > 1e-5 or not exact:
            raise AssertionError(f'K1 disagrees with its plain version on {name}')
        # ring is exact, so the fill error is the error over both outputs
        max_abs_err = max(max_abs_err, err)
        ring_exact = ring_exact and exact
    record = {}
    for name in ('main path', '64x1000x1000'):
        masks = cases[name]
        ms = time_ms(torch, lambda: k1.fused_overlay_postprocess(masks))
        plain_ms = time_ms(torch, lambda: k1.postprocess_chain(masks))
        px = masks.numel()
        bytes_ms = K1_BYTES_PER_PIXEL * px / HBM_BYTES_PER_S * 1e3
        ops_ms = K1_OPS_PER_PIXEL * px / FP32_FLOPS * 1e3
        log(f'K1 {name} {tuple(masks.shape)}: kernel {ms:.4f} ms, plain '
            f'{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms')
        if name == 'main path':
            record = {'shape': list(masks.shape), 'ms': ms, 'plain_ms': plain_ms,
                      'bound_ms': max(bytes_ms, ops_ms),
                      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations'}
        else:
            record['ms_64'], record['plain_ms_64'] = ms, plain_ms
            record['bound_ms_64'] = max(bytes_ms, ops_ms)
    record.update(max_abs_err=max_abs_err, ring_exact=ring_exact)
    return record


def k2_cases(torch):
    """{name: (imgs, masks, mats)} on the card: the training path's batch
    warped by the port's own draws with every geometric branch on, six 32 px
    maps, and a non-square frame."""
    from octseg_torch.ops import augment
    from octseg_torch.ops.warp import affine_matrix, matmul3, perspective_from_corners

    gen = torch.Generator(device='cuda').manual_seed(3)

    def batch(n, h, w):
        imgs = torch.rand((n, h, w, 3), generator=gen, device='cuda') * 255.0
        masks = (torch.rand((n, h, w, 4), generator=gen, device='cuda') > 0.6).float()
        return imgs, masks

    def drawn_maps(n, h, w):
        params = augment.draw_params(n, h, w, gen)
        for name in ('flip', 'ssr', 'crop', 'persp'):
            params[name] = torch.ones_like(params[name])
        m_pre, m_persp, _rect = augment.geometry(params, h, w)
        return matmul3(m_pre, m_persp).contiguous()

    cases = {'train path (4, 512, 512)': (*batch(4, 512, 512), drawn_maps(4, 512, 512))}
    s = 32
    c = torch.full((1,), (s - 1) / 2.0, device='cuda')
    one = torch.ones(1, device='cuda')
    zero = torch.zeros(1, device='cuda')
    corners = torch.tensor([[0.0, 0.0], [s - 1.0, 0.0], [s - 1.0, s - 1.0], [0.0, s - 1.0]],
                           device='cuda')
    jitter = torch.tensor([[3.0, 2.0], [-4.0, 1.0], [-1.0, -3.0], [1.0, 0.0]], device='cuda')
    small = {
        'identity': torch.eye(3, device='cuda')[None],
        'flip': torch.tensor([[[-1.0, 0.0, s - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]],
                             device='cuda'),
        'shift 3.7/-2.3': torch.tensor([[[1.0, 0.0, 3.7], [0.0, 1.0, -2.3], [0.0, 0.0, 1.0]]],
                                       device='cuda'),
        'scale 1.1': affine_matrix(zero, zero, 1.1 * one, zero, float(c), float(c)),
        'rotation 15': affine_matrix(2.0 * one, -one, 0.95 * one,
                                     torch.full((1,), 15 * 3.141592653589793 / 180, device='cuda'),
                                     float(c), float(c)),
        'perspective': perspective_from_corners((corners + jitter)[None], corners),
    }
    for name, mats in small.items():
        cases[f'32 px {name}'] = (*batch(1, s, s), mats.contiguous())
    cases['non-square (3, 130, 250)'] = (*batch(3, 130, 250), drawn_maps(3, 130, 250))
    return cases


def grid_sample_pair(torch, imgs, masks, mats):
    """The yardstick: F.grid_sample bilinear on the images and nearest on
    the masks, NCHW, at the kernel's sample positions (taps in float32,
    nearest rounding half to even: not the port's function)."""
    import torch.nn.functional as F

    from octseg_torch.ops.warp import apply_homography, pixel_grid

    n, h, w, _ = imgs.shape
    sx, sy = apply_homography(mats, *pixel_grid(h, w, imgs.device))
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1).contiguous()
    imgs_nchw = imgs.permute(0, 3, 1, 2).contiguous()
    masks_nchw = masks.permute(0, 3, 1, 2).contiguous()

    def run():
        F.grid_sample(imgs_nchw, grid, mode='bilinear', padding_mode='zeros', align_corners=True)
        F.grid_sample(masks_nchw, grid, mode='nearest', padding_mode='zeros', align_corners=True)

    return run


def check_k2(torch):
    """Kernel vs plain version on the card; returns the timing record."""
    from octseg_torch.ops.kernels import warp as k2
    from octseg_torch.ops.warp import sample_pair_plain

    max_abs_err, masks_exact, record = 0.0, True, {}
    for name, (imgs, masks, mats) in k2_cases(torch).items():
        img_w, mask_w = k2.warp_pair(imgs, masks, mats)
        torch.cuda.synchronize()
        p_img, p_mask = sample_pair_plain(imgs, masks, mats)
        err = float((img_w - p_img).abs().max())
        exact = bool(torch.equal(mask_w, p_mask))
        log(f'K2 {name}: image max |err| {err:.3g}, masks exact {exact}, '
            f'mask px {int(mask_w.sum())} of {mask_w.numel()}, image mean '
            f'{float(img_w.mean()):.2f}')
        if err > 1e-4 or not exact:
            raise AssertionError(f'K2 disagrees with its plain version on {name}')
        max_abs_err = max(max_abs_err, err)
        masks_exact = masks_exact and exact
        if name.startswith('train path'):
            n, h, w, ci = imgs.shape
            cm = masks.shape[3]
            ms = time_ms(torch, lambda: k2.warp_pair(imgs, masks, mats))
            plain_ms = time_ms(torch, lambda: sample_pair_plain(imgs, masks, mats))
            library_ms = time_ms(torch, grid_sample_pair(torch, imgs, masks, mats))
            px = n * h * w
            bytes_ms = (2 * 4 * (ci + cm) * px + 36 * n) / HBM_BYTES_PER_S * 1e3
            ops_ms = K2_OPS_PER_PIXEL * px / FP32_FLOPS * 1e3
            record = {'shape': [n, h, w, ci, cm], 'ms': ms, 'plain_ms': plain_ms,
                      'library_ms': library_ms, 'bound_ms': max(bytes_ms, ops_ms),
                      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations'}
            log(f'K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample '
                f'{library_ms:.4f} ms, bound {record["bound_ms"]:.4f} ms ({record["bound_by"]})')
    record.update(max_abs_err=max_abs_err, masks_exact=masks_exact)
    return record


def synthetic_pullback(n: int, size: int, seed: int):
    """(n, size, size) uint8 grayscale frames: a bright ring (the vessel
    wall) around a dark lumen, moving slowly, with speckle noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = np.empty((n, size, size), np.uint8)
    for i in range(n):
        cy = size / 2 + 20 * np.sin(i / 5)
        cx = size / 2 + 20 * np.cos(i / 7)
        r = np.hypot(yy - cy, xx - cx)
        wall = 180 * np.exp(-((r - size / 4) / 25) ** 2)
        frames[i] = np.clip(wall + rng.normal(30, 12, (size, size)), 0, 255)
    return frames


def png_size(path: str):
    with open(path, 'rb') as f:
        head = f.read(24)
    if head[:8] != b'\x89PNG\r\n\x1a\n' or head[12:16] != b'IHDR':
        raise AssertionError(f'{path} is not a PNG')
    return int.from_bytes(head[16:20], 'big'), int.from_bytes(head[20:24], 'big')


def main_path(tmp: str):
    import torch

    from octseg_torch.data import dicom
    from octseg_torch.infer.predict import main as predict
    from octseg_torch.ops.kernels import postprocess as k1
    from octseg_torch.ops.kernels import warp as k2
    from octseg_torch.train.checkpoint import initialize_model_dir

    models = os.path.join(tmp, 'models')
    t = time.perf_counter()
    initialize_model_dir(os.path.join(models, 'LM'), ['Lumen'], arch='UnetPlusPlus',
                         encoder='resnet101', input_size=512, seed=0)
    dcm = os.path.join(tmp, 'IMG001')
    dicom.dcmwrite(dcm, synthetic_pullback(MAIN_FRAMES, MAIN_FRAME_PX, 0))
    log(f'model dir + pullback written in {time.perf_counter() - t:.1f} s')
    out = os.path.join(tmp, 'predict')
    # the command line a user runs; block_size and output_resize come from
    # configs/predict.yaml
    overrides = [f'data_dir={dcm}', f'models_dir={models}', f'save_dir={out}',
                 f'output_size=[{MAIN_OUT},{MAIN_OUT}]', 'device=cuda', 'classes=[Lumen]']
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    result = predict(overrides=overrides)
    launches, k2_launches = k1.launches, k2.launches
    peak = torch.cuda.max_memory_allocated()
    pngs = sorted(f for f in os.listdir(out) if f.endswith('.png'))
    if len(pngs) != 2 * MAIN_FRAMES:
        raise AssertionError(f'expected {2 * MAIN_FRAMES} PNGs, found {len(pngs)}')
    for f in pngs:
        if png_size(os.path.join(out, f)) != (MAIN_OUT, MAIN_OUT):
            raise AssertionError(f'{f} is not {MAIN_OUT}x{MAIN_OUT}')
    if launches < 1:
        raise AssertionError('the main path did not launch the postprocess kernel')
    secs = result['seconds']
    log(f'main path: {result["frames"]} frames, {launches} K1 and {k2_launches} K2 launches, '
        f'{result["frames"] / secs["total"]:.2f} frames/s end to end; seconds per '
        f'stage {json.dumps({k: round(v, 3) for k, v in secs.items()})}; device '
        f'memory peak {peak / 2**30:.2f} GiB')
    return {'launches': launches, 'frames': result['frames'], 'seconds': secs,
            'peak_allocated_bytes': peak, 'dcm': dcm, 'models': models}


def block_memory(main):
    """Device memory peak of one block of predict.yaml's ``block_size``
    frames (the main path's pullback repeated) through the engine."""
    import numpy as np
    import torch

    from octseg_torch.core.config import load_config
    from octseg_torch.infer.engine import InferenceEngine
    from octseg_torch.infer.predict import load_pullback_frames

    cfg = load_config('predict')
    block = int(cfg.block_size)
    frames = load_pullback_frames(main['dcm'])
    frames = np.tile(frames, (-(-block // frames.shape[0]), 1, 1, 1))[:block]
    engine = InferenceEngine(main['models'], ['Lumen'], block_size=block,
                             output_resize=str(cfg.get('output_resize', 'prob_bilinear')),
                             device='cuda')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    blocks = [masks.shape[0] for _start, masks in
              engine.iter_pullback(frames, (MAIN_OUT, MAIN_OUT))]
    seconds = time.perf_counter() - t
    if blocks != [block]:
        raise AssertionError(f'expected one block of {block} frames, got {blocks}')
    record = {'block_size': block, 'frame_px': MAIN_FRAME_PX, 'seconds': seconds,
              'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
              'peak_reserved_bytes': torch.cuda.max_memory_reserved(),
              'device_total_bytes': torch.cuda.get_device_properties(0).total_memory}
    log(f'one {block}-frame block, UnetPlusPlus/resnet101 at 512 fp32: '
        f'{seconds:.2f} s, peak allocated '
        f'{record["peak_allocated_bytes"] / 2**30:.2f} GiB, reserved '
        f'{record["peak_reserved_bytes"] / 2**30:.2f} GiB of '
        f'{record["device_total_bytes"] / 2**30:.2f} GiB')
    return record


def probabilities(engine, name, frames, out_size):
    """The engine's pre-threshold probabilities for one model (CPU)."""
    import torch

    from octseg_torch.ops.normalize import normalize_imagenet
    from octseg_torch.ops.resize import resize_bilinear_nchw, resize_nearest_nchw

    model, cfg = engine._bundle(name)
    s = cfg['input_size']
    with torch.inference_mode():
        x = torch.from_numpy(frames).flip(-1).float().permute(0, 3, 1, 2)
        x = resize_bilinear_nchw(x, (s, s))
        x = x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x
        if cfg.get('normalize', False):
            x = normalize_imagenet(x, channel_dim=1)
        probs = torch.sigmoid(model(x.contiguous()))
        resize = (resize_bilinear_nchw if engine.output_resize == 'prob_bilinear'
                  else resize_nearest_nchw)
        return resize(probs, out_size).numpy()


def routing(tmp: str):
    import numpy as np

    from octseg_torch.infer.engine import MODELS_META, InferenceEngine
    from octseg_torch.train.checkpoint import initialize_model_dir

    models = os.path.join(tmp, 'small')
    for seed, (name, classes) in enumerate((('LM', ['Lumen']),
                                            ('FC_LC', ['Lipid core', 'Fibrous cap']),
                                            ('VV', ['Vasa vasorum']))):
        initialize_model_dir(os.path.join(models, name), classes, 'Unet', 'resnet18',
                             input_size=64, seed=seed)
    classes = list(MODELS_META)
    frames = np.random.default_rng(5).integers(0, 255, (8, 100, 90, 3), dtype=np.uint8)
    out_size = (80, 72)
    worst = 0.0
    for mode in ('prob_bilinear', 'nearest'):
        gpu = InferenceEngine(models, classes, block_size=3, output_resize=mode,
                              device='cuda').segment_pullback(frames, out_size)
        cpu_engine = InferenceEngine(models, classes, block_size=3, output_resize=mode,
                                     device='cpu')
        cpu = cpu_engine.segment_pullback(frames, out_size)
        # a pixel may flip only where the CPU probability is within 1e-4 of 0.5
        near = np.zeros_like(cpu, bool)
        for name, routes in cpu_engine._ensemble_plan().items():
            p = probabilities(cpu_engine, name, frames, out_size)
            for _cls, ch, mask_ch in routes:
                near[..., mask_ch] = np.abs(p[:, ch] - 0.5) < 1e-4
        diff = gpu != cpu
        share = near.mean()
        log(f'routing {mode}: {int(diff.sum())} differing px of {diff.size}, '
            f'{int(near.sum())} near 0.5 ({share:.2e}); class means '
            f'{cpu.mean(axis=(0, 1, 2)).round(3).tolist()}')
        if (diff & ~near).any() or share >= 1e-3:
            raise AssertionError(f'GPU and CPU routed masks disagree ({mode})')
        worst = max(worst, share)
    return worst


def logits_gpu_vs_cpu(main):
    import numpy as np
    import torch

    from octseg_torch.data import dicom
    from octseg_torch.infer.engine import fp32_exact, load_model_bundle
    from octseg_torch.ops.normalize import normalize_imagenet
    from octseg_torch.ops.resize import resize_bilinear_nchw

    frames = np.array(dicom.dcmread(main['dcm']).pixel_array[:2])
    x = torch.from_numpy(frames).float()[:, None]
    x = resize_bilinear_nchw(x, (512, 512)).expand(-1, 3, -1, -1)
    x = normalize_imagenet(x, channel_dim=1).contiguous()
    out = {}
    for device in ('cuda', 'cpu'):
        model, _cfg = load_model_bundle(os.path.join(main['models'], 'LM'), device)
        with torch.inference_mode(), fp32_exact():
            if device == 'cuda':
                log(f'cudnn allow_tf32 in the forward: {torch.backends.cudnn.allow_tf32}')
            out[device] = model(x.to(device)).float().cpu()
        del model
    err = float((out['cuda'] - out['cpu']).abs().max())
    scale = float(out['cpu'].abs().max())
    log(f'LM logits (2, 1, 512, 512) GPU vs CPU: max |delta| {err:.3g} '
        f'(max |logit| {scale:.3g})')
    if not err <= 1e-3:
        raise AssertionError(f'GPU and CPU logits differ by {err}')
    return err


def train_path(tmp: str):
    """The training path at full width: configs/train.yaml's Unet/resnet50
    at 512, batch 4, four classes, Adam, augmentation on, two epochs over a
    synthetic fold of 1000 px frames."""
    import csv
    import math

    import torch

    from octseg_torch.data.synth import make_synth_fold
    from octseg_torch.models import create_model
    from octseg_torch.ops.kernels import postprocess as k1
    from octseg_torch.ops.kernels import warp as k2
    from octseg_torch.train.checkpoint import restore_weights_into
    from octseg_torch.train.metrics import CSV_FIELDS
    from octseg_torch.train.train import main as train

    fold = os.path.join(tmp, 'fold')
    n_train, n_test, n_vis = TRAIN_SPLITS
    t = time.perf_counter()
    make_synth_fold(fold, n_train, n_test, size=TRAIN_FRAME_PX, seed=11, n_vis=n_vis)
    log(f'synthetic fold ({n_train}/{n_test}/{n_vis} at {TRAIN_FRAME_PX} px) written in '
        f'{time.perf_counter() - t:.1f} s')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    t = time.perf_counter()
    summary = train(overrides=[f'data_dir={fold}', f'save_dir={os.path.join(tmp, "train")}',
                               'epochs=2'])
    wall = time.perf_counter() - t
    launches = {'k1': k1.launches, 'k2': k2.launches}
    peak = torch.cuda.max_memory_allocated()

    model_dir = summary['model_dir']
    with open(os.path.join(model_dir, 'metrics.csv')) as f:
        reader = csv.DictReader(f)
        fields, rows = reader.fieldnames, list(reader)
    epochs, classes = 2, 4
    if fields != CSV_FIELDS or len(rows) != epochs * 2 * (classes + 1):
        raise AssertionError(f'metrics.csv: {fields}, {len(rows)} rows')
    if not all(math.isfinite(float(r['Loss'])) for r in rows):
        raise AssertionError('metrics.csv holds a non-finite loss')
    with open(os.path.join(model_dir, 'config.json')) as f:
        manifest = json.load(f)
    model = create_model(manifest['architecture'], manifest['encoder'],
                         classes=len(manifest['classes']))
    restore_weights_into(model, os.path.join(model_dir, 'weights.ckpt'),
                         manifest['architecture'], manifest['encoder'])
    if not os.path.isfile(os.path.join(model_dir, 'resume.ckpt')):
        raise AssertionError('no resume.ckpt')
    pngs = [f for f in os.listdir(os.path.join(model_dir, 'images_per_epoch'))
            if f.endswith('.png')]
    if len(pngs) != epochs * n_vis:
        raise AssertionError(f'images_per_epoch holds {len(pngs)} PNGs')
    steps = summary['train_steps']
    if steps != epochs * (n_train // int(manifest['batch_size'])) or launches['k2'] != steps:
        raise AssertionError(f'{steps} train steps, {launches["k2"]} K2 launches')
    breakdown = step_breakdown(torch, manifest['architecture'], manifest['encoder'],
                               len(manifest['classes']), int(manifest['input_size']),
                               int(manifest['batch_size']))
    secs = summary['seconds']
    loop = secs['data_wait'] + secs['train']
    record = {'model': f'{manifest["architecture"]}/{manifest["encoder"]}',
              'input_size': manifest['input_size'], 'batch_size': manifest['batch_size'],
              'train_steps': steps, 'train_samples': summary['train_samples'],
              'samples_per_s': summary['train_samples'] / loop, 'seconds': secs,
              'data_wait_share': secs['data_wait'] / loop, 'wall_s': wall,
              'peak_allocated_bytes': peak, 'launches': launches,
              'best_val_loss': summary['best_val_loss'], 'step': breakdown}
    log(f'training path: {record["model"]} at {record["input_size"]}, batch '
        f'{record["batch_size"]}: {steps} steps, {record["samples_per_s"]:.2f} samples/s in '
        f'the train loop, data-wait share {record["data_wait_share"]:.3f}; seconds per stage '
        f'{json.dumps({k: round(v, 3) for k, v in secs.items()})}; {wall:.1f} s in main(); '
        f'device memory peak {peak / 2**30:.2f} GiB; launches {launches}; best val loss '
        f'{summary["best_val_loss"]:.4f}')
    return record


def step_breakdown(torch, arch: str, encoder: str, classes: int, size: int, batch: int):
    """One training step at the training path's shapes without the loader:
    its time (CUDA events, median of 10), the augmentation's alone, and a
    profiler trace of 3 steps: device busy time by kernel and the idle share
    of the device over those steps' wall time (1 - busy / wall)."""
    from torch.profiler import ProfilerActivity, profile

    from octseg_torch.models import create_model
    from octseg_torch.ops.augment import augment_batch
    from octseg_torch.train.state import TrainState, make_optimizer
    from octseg_torch.train.train import init_model, make_train_step

    model = init_model(create_model(arch, encoder, classes=classes), 0).cuda()
    state = TrainState.create(model, make_optimizer('Adam', 1e-5))
    step = make_train_step(use_augmentation=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    imgs = torch.rand((batch, size, size, 3), device='cuda', generator=gen) * 255.0
    masks = (torch.rand((batch, size, size, classes), device='cuda', generator=gen) > 0.5).float()
    step_ms = time_ms(torch, lambda: step(state, imgs, masks, gen), runs=10, warmup=3)
    augment_ms = time_ms(torch, lambda: augment_batch(imgs, masks, gen), runs=10, warmup=2)
    # kernels only (no host-side op tracing, which would slow the host and
    # inflate the idle share); the wall time is taken inside the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            step(state, imgs, masks, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def device_us(e):
        return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0)

    # kernel events only: an operator's entry repeats its kernels' time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    top = [{'name': e.key[:80], 'ms_per_step': device_us(e) / 3e3} for e in kernels[:8]]
    record = {'step_ms': step_ms, 'augment_ms': augment_ms,
              'profiled_steps': 3, 'profiled_wall_ms': wall_ms,
              'device_busy_ms': busy_ms if busy_ms > 0 else None,
              'device_idle_share': 1 - busy_ms / wall_ms if busy_ms > 0 else None,
              'top_kernels': top}
    log(f'one training step ({arch}/{encoder} at {size}, batch {batch}, augmentation on): '
        f'{step_ms:.2f} ms, augmentation alone {augment_ms:.3f} ms; profiled 3 steps: wall '
        f'{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms'
        + (f', idle share {record["device_idle_share"]:.3f}' if busy_ms > 0 else
           ' (the profiler saw no device time: idle share not measured)'))
    for k in top:
        log(f'  {k["ms_per_step"]:8.3f} ms/step  {k["name"]}')
    return record


# worst parameter of |g_gpu - g_cpu| / |g_cpu| (L2) at the first step: 6.9e-3
# measured (cuDNN's float32 gradient against the CPU's); the control 0.47
GRAD_GAP_GPU = 2e-2
# worst parameter of |update_gpu - update_cpu| / |update_cpu| after three
# SGD steps at lr 1e-2: 0.055 measured; the control 1.55
UPDATE_GAP = 0.2


def train_step_gpu_vs_cpu():
    """Unet/resnet18 at 64 px, batch 4, four classes, no augmentation, from
    the same weights on the card (TF32 off) and on the CPU:

    - the first step's gradients: the worst parameter's relative L2 gap
      within GRAD_GAP_GPU; a control with one decoder skip connection
      detached (the same forward) must exceed it;
    - three SGD steps at lr 1e-2: per-step losses within 1e-4 relative,
      each parameter's update within UPDATE_GAP relative and every entry
      within 1e-4; a control loop that never clears the gradients must
      exceed UPDATE_GAP;
    - three Adam steps at lr 1e-3: per-step losses within 1e-4 relative,
      entries within 3 lr steps. The share of entries within 1e-4 is
      printed, not held: Adam's first steps move each entry by about lr
      whatever its gradient, and entries whose gradients differ in the
      float32 noise step apart and move the next steps' gradients."""
    import copy

    import numpy as np
    import torch

    from octseg_torch.infer.engine import fp32_exact
    from octseg_torch.models import create_model
    from octseg_torch.train.state import TrainState, make_optimizer
    from octseg_torch.train.train import _loss_and_logits, init_model, make_train_step

    steps = 3
    base = init_model(create_model('Unet', 'resnet18', classes=4), seed=0)
    rng = np.random.default_rng(9)
    imgs = rng.uniform(0, 255, (steps, 4, 64, 64, 3)).astype(np.float32)
    masks = (rng.random((steps, 4, 64, 64, 4)) > 0.7).astype(np.float32)

    def worst_gap(got, want):
        gaps = {k: float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]))
                for k in want}
        name = max(gaps, key=gaps.get)
        return gaps[name], name

    def gradients(device, skipless=False):
        model = copy.deepcopy(base).to(device).train()
        if skipless:
            model.decoder.blocks[1].register_forward_pre_hook(
                lambda _, a: (a[0], a[1].detach()))
        with fp32_exact():
            loss, _, _ = _loss_and_logits(model, torch.from_numpy(imgs[0]).to(device),
                                          torch.from_numpy(masks[0]).to(device))
            loss.backward()
        return {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()}

    def run(device, name, lr, keep_gradients=False):
        model = copy.deepcopy(base).to(device)
        state = TrainState.create(model, make_optimizer(name, lr))
        if keep_gradients:
            def apply_gradients():
                params = state.params_of(model)
                state.tx.step(params, [p.grad for p in params], state.opt_state)
                state.step += 1
            state.apply_gradients = apply_gradients
        step = make_train_step(use_augmentation=False)
        losses = [float(step(state, torch.from_numpy(imgs[k]).to(device),
                             torch.from_numpy(masks[k]).to(device),
                             torch.Generator(device=device))['loss']) for k in range(steps)]
        return np.array(losses), {k: p.detach().double().cpu().numpy()
                                  for k, p in model.named_parameters()}

    start = {k: p.detach().double().numpy() for k, p in base.named_parameters()}
    cpu_grads = gradients('cpu')
    grad_gap, grad_worst = worst_gap(gradients('cuda'), cpu_grads)
    control_grad_gap, _ = worst_gap(gradients('cuda', skipless=True), cpu_grads)
    out = {'grad_worst_rel_gap': grad_gap, 'grad_worst_param': grad_worst,
           'control_skip_detached_grad_gap': control_grad_gap}
    log(f'train step GPU vs CPU, first-step gradients: worst relative gap {grad_gap:.3g} '
        f'({grad_worst}), limit {GRAD_GAP_GPU}; control (a skip detached) {control_grad_gap:.3g}')
    for name, lr in (('SGD', 1e-2), ('Adam', 1e-3)):
        (gl, gp), (cl, cp) = run('cuda', name, lr), run('cpu', name, lr)
        loss_rel = float(np.max(np.abs(gl - cl) / np.abs(cl)))
        gaps = np.concatenate([np.abs(gp[k] - cp[k]).ravel() for k in start])
        update_gap, _ = worst_gap({k: gp[k] - start[k] for k in start},
                                  {k: cp[k] - start[k] for k in start})
        rec = {'lr': lr, 'losses_gpu': gl.tolist(), 'losses_cpu': cl.tolist(),
               'loss_max_rel_gap': loss_rel, 'update_worst_rel_gap': update_gap,
               'param_max_gap': float(gaps.max()),
               'param_share_within_1e-4': float((gaps <= 1e-4).mean())}
        if name == 'SGD':
            _, bad = run('cuda', name, lr, keep_gradients=True)
            rec['control_kept_gradients_update_gap'], _ = worst_gap(
                {k: bad[k] - start[k] for k in start}, {k: cp[k] - start[k] for k in start})
        log(f'train step GPU vs CPU, {name} lr {lr}: losses {gl.tolist()} vs {cl.tolist()}, '
            f'largest relative loss gap {loss_rel:.3g}; worst relative update gap '
            f'{update_gap:.3g}; largest parameter gap {rec["param_max_gap"]:.3g}, share within '
            f'1e-4 {rec["param_share_within_1e-4"]:.5f}'
            + (f'; control (gradients never cleared) {rec["control_kept_gradients_update_gap"]:.3g}'
               if name == 'SGD' else ''))
        out[f'{name}_lr_{lr:g}'] = rec
    sgd, adam = out['SGD_lr_0.01'], out['Adam_lr_0.001']
    if (grad_gap > GRAD_GAP_GPU or control_grad_gap <= GRAD_GAP_GPU
            or sgd['loss_max_rel_gap'] > 1e-4 or sgd['update_worst_rel_gap'] > UPDATE_GAP
            or sgd['param_max_gap'] > 1e-4
            or sgd['control_kept_gradients_update_gap'] <= UPDATE_GAP
            or adam['loss_max_rel_gap'] > 1e-4 or adam['param_max_gap'] > 3 * 1e-3 * steps):
        raise AssertionError(f'GPU and CPU train steps disagree: {out}')
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log('no CUDA device: chip_smoke.py runs on a GPU')
        return 2
    sys.path.insert(0, REPO)
    phases = Phases()
    print(card_line(), flush=True)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')
    from octseg_torch.ops.kernels import _build

    def build(names):
        # one nvcc per source, all started together
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(_build.load, names))

    phases.run('build', build, ['postprocess', 'warp'])
    k1 = phases.run('K1 vs plain', check_k1, torch)
    k2 = phases.run('K2 vs plain', check_k2, torch)
    tmp = tempfile.mkdtemp(prefix='octseg_torch_smoke_')
    try:
        main = phases.run('predict path', main_path, tmp)
        memory = phases.run('block memory', block_memory, main)
        share = phases.run('routing GPU vs CPU', routing, tmp)
        logit_err = phases.run('logits GPU vs CPU', logits_gpu_vs_cpu, main)
        train = phases.run('training path', train_path, tmp)
        step_gaps = phases.run('train step GPU vs CPU', train_step_gpu_vs_cpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [{
        'name': 'fused_overlay_postprocess',
        'route': 'cuda',
        'source': 'octseg_torch/csrc/postprocess.cu',
        'replaces': 'octseg/ops/pallas/postprocess.py:149',
        'launches': main['launches'],
        'shape': k1['shape'],
        'max_abs_err': k1['max_abs_err'],
        'ring_exact': k1['ring_exact'],
        'ms': k1['ms'],
        'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
        'library_ms': None,
        'ms_64x1000x1000': k1['ms_64'], 'plain_ms_64x1000x1000': k1['plain_ms_64'],
        'bound_ms_64x1000x1000': k1['bound_ms_64'],
    }, {
        'name': 'warp_pair',
        'route': 'cuda',
        'source': 'octseg_torch/csrc/warp.cu',
        'replaces': 'octseg/ops/pallas/resample.py:116',
        'launches': train['launches']['k2'],
        'shape': k2['shape'],
        'max_abs_err': k2['max_abs_err'],
        'masks_exact': k2['masks_exact'],
        'ms': k2['ms'],
        'plain_ms': k2['plain_ms'],
        'bound_ms': k2['bound_ms'], 'bound_by': k2['bound_by'],
        'library_ms': k2['library_ms'],
    }]
    print(json.dumps({'kernels': kernels,
                      'predict_path': {'frames': main['frames'], 'seconds': main['seconds'],
                                       'peak_allocated_bytes': main['peak_allocated_bytes']},
                      'block_memory': memory,
                      'routing_near_half_share': share,
                      'logits_max_abs_delta': logit_err,
                      'training_path': train,
                      'train_step_gpu_vs_cpu': step_gaps}), flush=True)
    log(f'total {time.perf_counter() - phases.t0:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
