#!/usr/bin/env python3
"""Smoke run of octseg_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)

Phases, each raising on failure (exit code != 0):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the port's CUDA kernel with nvcc;
  3. the fused overlay postprocess kernel against its plain torch version on
     the card (ring bit-exact, fill within 1e-5) at the main path's shape and
     at test shapes, timed with CUDA events beside the plain version and the
     card's bound;
  4. the main path at full width: a UnetPlusPlus/resnet101 Lumen model dir
     at 512 px (random weights from a seed), a 32-frame 704x704 grayscale
     DICOM pullback, ``octseg_torch.infer.predict.main`` with
     configs/predict.yaml's block size to 1000x1000 overlay PNGs; the
     kernel's launch count must rise;
  4b. the device memory peak of one full block (predict.yaml's
     ``block_size`` frames) through the engine;
  5. ensemble routing with three Unet/resnet18 model dirs at 64 px over all
     four classes, GPU against CPU;
  6. the Lumen model's logits on 2 frames, GPU (TF32 off) against CPU;
  7. one JSON line per kernel; last, the result line.

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

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
K1_BYTES_PER_PIXEL = 12       # 4 B mask read, 4 B fill + 4 B ring written
K1_OPS_PER_PIXEL = 118        # 2x16 + 2x32 max, 3 complements, 1 product, 2x9 blur
MAIN_FRAMES, MAIN_FRAME_PX, MAIN_OUT = 32, 704, 1000


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
    k1.launches = 0
    result = predict(overrides=overrides)
    launches = k1.launches
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
    log(f'main path: {result["frames"]} frames, {launches} K1 launches, '
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

    t = time.perf_counter()
    phases.run('build', _build.load, 'postprocess')
    log(f'kernel built in {time.perf_counter() - t:.1f} s')
    k1 = phases.run('K1 vs plain', check_k1, torch)
    tmp = tempfile.mkdtemp(prefix='octseg_torch_smoke_')
    try:
        main = phases.run('main path', main_path, tmp)
        memory = phases.run('block memory', block_memory, main)
        share = phases.run('routing GPU vs CPU', routing, tmp)
        logit_err = phases.run('logits GPU vs CPU', logits_gpu_vs_cpu, main)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernel = {
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
    }
    print(json.dumps({'kernels': [kernel],
                      'main_path': {'frames': main['frames'],
                                    'seconds': main['seconds'],
                                    'peak_allocated_bytes': main['peak_allocated_bytes']},
                      'block_memory': memory,
                      'routing_near_half_share': share,
                      'logits_max_abs_delta': logit_err}), flush=True)
    log(f'total {time.perf_counter() - phases.t0:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
