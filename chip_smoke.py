#!/usr/bin/env python3
"""Smoke run of octseg_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)

Phases, each raising on failure (exit code != 0):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the port's CUDA kernels with nvcc and the JPEG entropy decoder
     and the contour tracer (host C++) with g++, one process per source,
     all started together;
  3. K1, the fused overlay postprocess kernel, against its plain torch
     version on the card (ring bit-exact, fill within 1e-5) at the predict
     path's shape (128, 1000, 1000), at 32 and 64 masks of 1000x1000, and
     at test shapes: widths 3, 31, 32, 33 and 1000 (word
     boundaries), heights 3 and 4, masks all ones, all zeros and touching
     all four borders, three column tiles (2100 px) and 65537 masks; timed
     with CUDA events beside the plain version and the card's bound;
  4. K2, the augmentation warp kernel, against its plain torch version
     (masks bit-exact, images within 1e-4 on 0..255) at the training
     path's shape (4, 512, 512) with every geometric branch on, the tune
     and zoo train steps' shape (2, 896, 896) with 3 + 1 channels (the
     kernel's general path), six 32 px maps, a non-square frame, 1 + 1 and
     3 + 1 channels and a width that is not a multiple of 4; both path
     shapes timed warm and with a cold L2 (their inputs fit in the L2)
     beside the plain version, the bound and F.grid_sample (a yardstick the
     port never calls);
  5. the predict path at full width: the reference's hybrid ensemble, three
     model dirs with random weights from seeds 0-2 (LM UnetPlusPlus/resnet101
     at 512, FC_LC LinkNet/efficientnet-b7 at 896, VV Unet/timm-regnetx_064
     at 896), a 32-frame 704x704 grayscale DICOM pullback,
     ``octseg_torch.infer.predict.main`` with configs/predict.yaml's four
     classes and block size to 1000x1000 overlay PNGs; K1 must launch on
     frames x classes = 128 masks;
  5a. JPEG: the C++ entropy decoder against its plain Python version,
     bit-exact, on every file of tests/torch_fixtures/jpeg/ (a 16-frame
     704x704 4:2:0 JPEG Baseline DICOM pullback and five small JPEGs), ms
     per frame of each; the fixture's pullback through the predict path
     (full ensemble, output 1000x1000); an image directory of 8 RGB PNGs at
     1000x1000 and 8 of the fixture's frames as .jpg files through the
     image-directory predict path; every overlay and mask PNG written at
     1000x1000 and K1 launched; seconds per stage;
  5b. blocks of predict.yaml's ``block_size`` frames and of 32 through each
     model alone, and a full block through the ensemble: each model's
     probe-chosen chunk, predicted and measured device memory peaks,
     forward seconds; each model's blocks again with the allocator capped
     at predicted / CHUNK_MARGIN (must fit) and at predicted / 0.8
     (recorded); then K1 on the ensemble block's masks, whose buffers must
     fit in what the forwards freed;
  5c. bf16: each model's 128-frame block with bf16=true under the cap of
     predicted / CHUNK_MARGIN (must fit); the 32-frame pullback through the
     ensemble with softened heads in bf16 against fp32, per class the share
     of differing pixels where the fp32 probability is at least BF16_BAND
     from 0.5 within BF16_MASK_SHARE; the predict path with bf16=true;
  5d. serve: configs/serve.yaml unchanged (bf16, block 128, four classes,
     1000x1000) over the softened ensemble, the service in process on
     127.0.0.1:0; the 32-frame pullback streamed in format=masks (cold and
     warm: frames/s, first-block latency), its blocks equal to the server
     engine's masks except within 1e-4 of p = 0.5; format=quant (seconds)
     equal to ``quantify_blocks`` with the Python contour tracer over those
     masks; the C++ and Python tracers equal on every channel that counts
     (ms per 1000x1000 mask of each); the port's client in masks mode (K1
     once per streamed block; render seconds) against a local bf16 predict,
     PNGs byte-identical; 503 with Retry-After while the admission
     semaphore is held; /healthz says gpu, /metrics counts the requests;
  6. ensemble routing with the three families at 64 px (UnetPlusPlus/
     resnet101, LinkNet/efficientnet-b7, Unet/timm-regnetx_064) over all
     four classes, GPU against CPU;
  7. each ensemble model's logits on 2 frames at its input size, GPU (TF32
     off) against CPU;
  8. the training path at full width: a synthetic fold of 1000 px frames
     (16 train, 4 test, 2 vis), ``octseg_torch.train.train.main`` for two
     epochs with every other key from configs/train.yaml (Unet/resnet50 at
     512, batch 4, four classes, Adam, augmentation on); K2 must launch once
     per training step; then one step at those shapes timed alone and
     profiled (device busy time by kernel, idle share);
  8b. the training path again with bf16=true; one fp32 step of Unet/
     resnet50 at 512 with remat on and off (gradients within
     REMAT_GRAD_GAP, BatchNorm statistics within BN_STATS_ATOL); the memory
     peak of one bf16 step of LinkNet/efficientnet-b7 at 896, batch 4, with
     and without remat;
  8c. evaluate: configs/evaluate.yaml's entry point on the training path's
     model dir and its fold's test split on the card, and on the CPU:
     metrics within EVAL_ATOL, (sample, class) masks equal where no
     probability is within 1e-4 of 0.5; seconds;
  8d. folds: the fold driver with configs/train.yaml over two synthetic
     folds (8 train and 4 test frames at 1000 px), one epoch each:
     folds_summary.csv and each fold dir's files, K2 once per step;
  9. Unet/resnet18 at 64 px, GPU (TF32 off) against CPU, from the same
     weights: the first step's gradients, three SGD steps and three Adam
     steps, with controls that must fail;
 10. the rest of the model zoo (ZOO: FPN/efficientnet-b7, PSPNet/resnet101,
     PAN/timm-regnetx_064 at output stride 16, MAnet/timm-regnety_120,
     DeepLabV3/resnet101 at 8, DeepLabV3Plus/efficientnet-b5 at 16): each
     model's logits on 2 frames at 512, GPU (TF32 off) against CPU within
     LOGITS_ATOL; the predict path with configs/predict.yaml unchanged over
     ZOO_ENSEMBLE (LM DeepLabV3/resnet101 at 512, FC_LC DeepLabV3Plus/
     efficientnet-b5 and VV PAN/timm-regnetx_064 at 896) on the 32-frame
     pullback, K1 on 128 masks, and each model's probe-chosen chunk with
     its predicted and measured peaks; one fp32 training step of each ZOO
     model and of ZOO_HEAVIEST (DeepLabV3/efficientnet-b7) at tune.yaml's
     896, batch 2, augmentation on (ms per step, memory peak; remat only
     where plain runs out of memory), K2 once per step;
 11. tune: ``octseg_torch.tune.tune.main`` over configs/tune.yaml's space
     unchanged, cut in depth (TUNE_SPLITS frames at 1000 px, TUNE_TRIALS
     trials, TUNE_EPOCHS epochs, TUNE_N_RANDOM random trials so the rest
     come from the GP-EI): every trial ``ok``, K2 once per step; then one
     trial more, which alone runs (resume);
 12. one JSON line of kernels; last, the result line.

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
# the reference's ensemble (bench.py): model dir, classes in channel order,
# architecture, encoder, input size; model dir k gets seed k
ENSEMBLE = (('LM', ['Lumen'], 'UnetPlusPlus', 'resnet101', 512),
            ('FC_LC', ['Lipid core', 'Fibrous cap'], 'LinkNet', 'efficientnet-b7', 896),
            ('VV', ['Vasa vasorum'], 'Unet', 'timm-regnetx_064', 896))
LOGITS_ATOL = 1e-3            # GPU against CPU, every ensemble model (PERF.md)
K2_OPS_PER_PIXEL = 60         # coordinates 15, per channel 7 blend or 1 select
TRAIN_FRAME_PX = 1000         # the dataset's frames (configs/convert_sly_to_int.yaml)
TRAIN_SPLITS = (16, 4, 2)     # train, test, vis samples of the synthetic fold
JPEG_FIXTURE = os.path.join(REPO, 'tests', 'torch_fixtures', 'jpeg')
IMAGE_DIR_PNGS = 8            # RGB PNGs at MAIN_OUT beside 8 of the fixture's JPEG frames
# bf16 against fp32 predict (bounds stated in PERF.md before the first run):
# per class, the share of pixels whose masks differ where the fp32
# probability is at least BF16_BAND from 0.5 must stay within BF16_MASK_SHARE
BF16_BAND = 0.05
BF16_MASK_SHARE = 1e-3
# the rest of the model zoo: one model per new architecture, over all three
# encoder families and both dilations (PAN and DeepLabV3Plus at output
# stride 16, DeepLabV3 at 8); the heaviest pair of configs/tune.yaml's space;
# an ensemble of them through the predict path (model dir, classes,
# architecture, encoder, input size)
ZOO = (('FPN', 'efficientnet-b7'), ('PSPNet', 'resnet101'), ('PAN', 'timm-regnetx_064'),
       ('MAnet', 'timm-regnety_120'), ('DeepLabV3', 'resnet101'),
       ('DeepLabV3Plus', 'efficientnet-b5'))
ZOO_HEAVIEST = ('DeepLabV3', 'efficientnet-b7')
ZOO_ENSEMBLE = (('LM', ['Lumen'], 'DeepLabV3', 'resnet101', 512),
                ('FC_LC', ['Lipid core', 'Fibrous cap'], 'DeepLabV3Plus', 'efficientnet-b5', 896),
                ('VV', ['Vasa vasorum'], 'PAN', 'timm-regnetx_064', 896))
ZOO_LOGITS_PX, ZOO_LOGITS_FRAMES = 512, 2
# the largest |logit| the zoo's GPU-vs-CPU check compares at: random weights
# put PAN's logits near 1e4, where float32 resolves 1e-3 alone
ZOO_LOGIT_SCALE = 10.0
# the tune phase's cuts of depth (configs/tune.yaml's space is unchanged):
# a synthetic fold of train and test frames at TRAIN_FRAME_PX, trials,
# epochs, HyperBand's first rung and random trials before GP-EI
TUNE_SPLITS = (8, 4)
TUNE_TRIALS, TUNE_EPOCHS, TUNE_MIN_ITER, TUNE_N_RANDOM = 4, 2, 1, 2
# remat against plain, one fp32 step of Unet/resnet50 at 512 (bounds stated
# in PERF.md before the first run): the worst parameter's relative L2
# gradient gap; BatchNorm running statistics within BN_STATS_ATOL
REMAT_GRAD_GAP = 1e-4
BN_STATS_ATOL = 1e-6


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


def edge_masks(torch, kind: str, shape, seed: int):
    """Masks on the card: all ones, all zeros, a frame touching all four
    borders over sparse noise, or random bits (one in ten set: denser noise
    closes into all ones)."""
    if kind == 'ones':
        return torch.ones(shape, device='cuda')
    if kind == 'zeros':
        return torch.zeros(shape, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    if kind == 'random':
        return (torch.rand(shape, generator=gen, device='cuda') > 0.9).float()
    masks = (torch.rand(shape, generator=gen, device='cuda') > 0.8).float()
    masks[:, 0, :] = masks[:, -1, :] = 1
    masks[:, :, 0] = masks[:, :, -1] = 1
    masks[:, 1:3, 1:3] = 0
    return masks


L2_SCRUB_BYTES = 64 << 20     # more than the H100's 50 MB L2
HOLD_CYCLES = 2_000_000       # about 1 ms of device clock: longer than a call's host side


def time_ms(torch, fn, runs: int = 25, warmup: int = 3, cold_l2: bool = False,
            hold: bool = False) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``, after warm-up.
    With ``hold`` (for a kernel and its one-call yardstick), the device is
    held busy (``torch.cuda._sleep``) before each start event for longer
    than the host takes to enqueue ``fn``, so the window holds the device's
    time and not the host's launch overhead. Without it (chains of many
    launches: the plain versions, a training step, the augmentation) the
    window also holds the host's enqueue time, as the users of those chains
    wait for it. With ``cold_l2``, each timed call follows, outside the
    event window, a write of one 64 MB buffer and a read of another: the L2
    then holds none of ``fn``'s inputs and no dirty lines whose write-back
    would fall inside the window."""
    scrub = ([torch.empty(L2_SCRUB_BYTES // 4, device='cuda') for _ in range(2)]
             if cold_l2 else None)
    for _ in range(warmup):
        fn()
    times = []
    for i in range(runs):
        if scrub:
            scrub[0].fill_(float(i))
            scrub[1].sum()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
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
        # the main path: 32 frames x 4 classes
        'main path': blob_masks(torch, 4 * MAIN_FRAMES, MAIN_OUT, MAIN_OUT, 1),
        '32x1000x1000': blob_masks(torch, 32, 1000, 1000, 4),
        '64x1000x1000': blob_masks(torch, 64, 1000, 1000, 2),
        '3x130x250': blob_masks(torch, 3, 130, 250, 3),
        'border 1x64x200': border_masks(torch),
    }
    # word boundaries: 1000 = 31 words + 8 bits; 2100 px = three column tiles;
    # 65537 masks, more than one grid's z
    for w in (3, 31, 32, 33, 1000):
        for h in (3, 4):
            cases[f'random 2x{h}x{w}'] = edge_masks(torch, 'random', (2, h, w), h * w)
    for kind in ('ones', 'zeros', 'border'):
        for shape in ((1, 3, 3), (2, 37, 33), (2, 70, 1000)):
            cases[f'{kind} {"x".join(map(str, shape))}'] = edge_masks(torch, kind, shape, 7)
    cases['random 1x40x2100'] = edge_masks(torch, 'random', (1, 40, 2100), 8)
    cases['random 65537x3x5'] = edge_masks(torch, 'random', (65537, 3, 5), 9)
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
    for name in ('main path', '32x1000x1000', '64x1000x1000'):
        masks = cases[name]
        ms = time_ms(torch, lambda: k1.fused_overlay_postprocess(masks), hold=True)
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
            m = masks.shape[0]
            record[f'ms_{m}'], record[f'plain_ms_{m}'] = ms, plain_ms
            record[f'bound_ms_{m}'] = max(bytes_ms, ops_ms)
    record.update(max_abs_err=max_abs_err, ring_exact=ring_exact)
    return record


def k2_cases(torch):
    """{name: (imgs, masks, mats)} on the card: the training path's batch
    warped by the port's own draws with every geometric branch on, six 32 px
    maps, and a non-square frame."""
    from octseg_torch.ops import augment
    from octseg_torch.ops.warp import affine_matrix, matmul3, perspective_from_corners

    gen = torch.Generator(device='cuda').manual_seed(3)

    def batch(n, h, w, ci=3, cm=4):
        imgs = torch.rand((n, h, w, ci), generator=gen, device='cuda') * 255.0
        masks = (torch.rand((n, h, w, cm), generator=gen, device='cuda') > 0.6).float()
        return imgs, masks

    def drawn_maps(n, h, w):
        params = augment.draw_params(n, h, w, gen)
        for name in ('flip', 'ssr', 'crop', 'persp'):
            params[name] = torch.ones_like(params[name])
        m_pre, m_persp, _rect = augment.geometry(params, h, w)
        return matmul3(m_pre, m_persp).contiguous()

    cases = {'train path (4, 512, 512)': (*batch(4, 512, 512), drawn_maps(4, 512, 512)),
             # the tune and zoo train steps: configs/tune.yaml's batch at its
             # largest size, one class (the general path: 3 + 1 channels)
             'tune path (2, 896, 896) 3+1': (*batch(2, 896, 896, 3, 1),
                                             drawn_maps(2, 896, 896))}
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
    # the general path: other channel counts, a width that is not a multiple of 4
    for ci, cm in ((1, 1), (3, 1)):
        cases[f'{ci} + {cm} channels (2, 96, 128)'] = (*batch(2, 96, 128, ci, cm),
                                                       drawn_maps(2, 96, 128))
    cases['unaligned width (2, 64, 61)'] = (*batch(2, 64, 61), drawn_maps(2, 64, 61))
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


# the K2 cases timed beside their bounds: the train path's fast path (3 + 4
# channels) and the tune path's general path (3 + 1)
K2_TIMED = ('train path (4, 512, 512)', 'tune path (2, 896, 896) 3+1')


def time_k2(torch, k2, imgs, masks, mats):
    """K2 on one case, warm and with a cold L2, beside its plain version,
    the grid_sample pair and its bound."""
    from octseg_torch.ops.warp import sample_pair_plain

    n, h, w, ci = imgs.shape
    cm = masks.shape[3]
    # the inputs of both timed cases (29 and 26 MB) fit in the 50 MB L2:
    # timed warm and cold
    ms = time_ms(torch, lambda: k2.warp_pair(imgs, masks, mats), hold=True)
    ms_cold = time_ms(torch, lambda: k2.warp_pair(imgs, masks, mats), cold_l2=True, hold=True)
    plain_ms = time_ms(torch, lambda: sample_pair_plain(imgs, masks, mats))
    yardstick = grid_sample_pair(torch, imgs, masks, mats)
    library_ms = time_ms(torch, yardstick, hold=True)
    library_cold = time_ms(torch, yardstick, cold_l2=True, hold=True)
    px = n * h * w
    bytes_ms = (2 * 4 * (ci + cm) * px + 36 * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = K2_OPS_PER_PIXEL * px / FP32_FLOPS * 1e3
    return {'shape': [n, h, w, ci, cm], 'ms': ms, 'ms_cold_l2': ms_cold,
            'plain_ms': plain_ms, 'library_ms': library_ms,
            'library_ms_cold_l2': library_cold, 'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations'}


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
        if name in K2_TIMED:
            rec = time_k2(torch, k2, imgs, masks, mats)
            log(f'K2 {name}: kernel {rec["ms"]:.4f} ms warm, {rec["ms_cold_l2"]:.4f} ms cold '
                f'L2; plain {rec["plain_ms"]:.4f} ms; grid_sample {rec["library_ms"]:.4f} ms '
                f'warm, {rec["library_ms_cold_l2"]:.4f} ms cold L2; bound '
                f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]})')
            if name.startswith('train path'):
                record.update(rec)
            else:
                tag = 'x'.join(map(str, rec['shape'][:3])) + 'x{}x{}'.format(*rec['shape'][3:])
                record.update({f'{k}_{tag}': v for k, v in rec.items()})
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


def make_ensemble(models: str, size_of=None, ensemble=ENSEMBLE) -> str:
    """The three model dirs of ``ensemble`` under ``models`` (random
    weights, seeds 0-2), each at its input size or at ``size_of(name)``."""
    from octseg_torch.train.checkpoint import initialize_model_dir

    for seed, (name, classes, arch, encoder, size) in enumerate(ensemble):
        initialize_model_dir(os.path.join(models, name), classes, arch=arch, encoder=encoder,
                             input_size=size_of(name) if size_of else size, seed=seed)
    return models


def predict_recorded(overrides, classes, out: str):
    """``octseg_torch.infer.predict.main(overrides=...)`` with the render's
    postprocess calls recorded: (result, K1 launches, the postprocess
    shapes, each class's positive pixels (masks stacked frame by frame,
    classes inner)). Checks that every overlay and mask PNG was written at
    MAIN_OUT and that K1 launched once on all MAIN_FRAMES x classes masks."""
    import torch

    from octseg_torch.data import utils as data_utils
    from octseg_torch.infer.predict import main as predict
    from octseg_torch.ops.kernels import postprocess as k1

    shapes, positive = [], torch.zeros(len(classes), dtype=torch.float64)
    postprocess_masks = data_utils.postprocess_masks

    def recorded(m):
        shapes.append(tuple(m.shape))
        positive.add_(m.view(-1, len(classes), *m.shape[1:]).double().sum((0, 2, 3)).cpu())
        return postprocess_masks(m)

    data_utils.postprocess_masks = recorded
    try:
        k1.launches = 0
        result = predict(overrides=overrides)
        launches = k1.launches
    finally:
        data_utils.postprocess_masks = postprocess_masks
    pngs = sorted(f for f in os.listdir(out) if f.endswith('.png'))
    if len(pngs) != 2 * MAIN_FRAMES:
        raise AssertionError(f'expected {2 * MAIN_FRAMES} PNGs, found {len(pngs)}')
    for f in pngs:
        if png_size(os.path.join(out, f)) != (MAIN_OUT, MAIN_OUT):
            raise AssertionError(f'{f} is not {MAIN_OUT}x{MAIN_OUT}')
    want_shapes = [(len(classes) * MAIN_FRAMES, MAIN_OUT, MAIN_OUT)]
    if launches < 1 or shapes != want_shapes:
        raise AssertionError(f'the postprocess ran on {shapes} with {launches} K1 launches, '
                             f'expected {want_shapes} launched')
    return result, launches, shapes, positive


def main_path(tmp: str):
    import torch

    from octseg_torch.core.config import load_config
    from octseg_torch.data import dicom
    from octseg_torch.ops.kernels import warp as k2

    classes = list(load_config('predict').classes)
    t = time.perf_counter()
    models = make_ensemble(os.path.join(tmp, 'models'))
    dcm = os.path.join(tmp, 'IMG001')
    dicom.dcmwrite(dcm, synthetic_pullback(MAIN_FRAMES, MAIN_FRAME_PX, 0))
    log(f'model dirs + pullback written in {time.perf_counter() - t:.1f} s')
    out = os.path.join(tmp, 'predict')
    # the command line a user runs; classes, block_size and output_resize
    # come from configs/predict.yaml
    overrides = [f'data_dir={dcm}', f'models_dir={models}', f'save_dir={out}',
                 f'output_size=[{MAIN_OUT},{MAIN_OUT}]', 'device=cuda']
    torch.cuda.reset_peak_memory_stats()
    k2.launches = 0
    result, launches, shapes, positive = predict_recorded(overrides, classes, out)
    k2_launches = k2.launches
    peak = torch.cuda.max_memory_allocated()
    # random weights: a class may be empty, so the shares are a record
    shares = dict(zip(classes, (positive / (MAIN_FRAMES * MAIN_OUT * MAIN_OUT)).tolist()))
    secs = result['seconds']
    log(f'main path: {result["frames"]} frames, classes {classes}, {launches} K1 launch(es) '
        f'on {shapes}, {k2_launches} K2 launches, {result["frames"] / secs["total"]:.2f} '
        f'frames/s end to end; seconds per stage '
        f'{json.dumps({k: round(v, 3) for k, v in secs.items()})}; chunks {result["chunks"]}; '
        f'device memory peak {peak / 2**30:.2f} GiB; positive share per class '
        f'{json.dumps({k: round(v, 4) for k, v in shares.items()})}')
    return {'launches': launches, 'k1_shapes': shapes, 'frames': result['frames'],
            'seconds': secs, 'chunks': result['chunks'], 'positive_share': shares,
            'peak_allocated_bytes': peak, 'dcm': dcm, 'models': models}


def block_memory(main, bf16: bool = False):
    """Blocks of the main path's pullback (repeated) through each ensemble
    model alone, at predict.yaml's ``block_size`` frames and at the main
    path's 32, and one full block through the ensemble: each model's chunk
    as the engine's probe chose it, the predicted and the measured device
    memory peaks (a second pass over the block, after the probe) and that
    pass's seconds; then K1 on the ensemble's masks of the full block, which
    must fit in the memory the forwards released to the allocator's cache.

    The engine's margin: each model's block runs again with the allocator
    allowed to reserve only its predicted peak / CHUNK_MARGIN, which must
    fit, and only its predicted peak / 0.8, which is recorded (out of
    memory or its peak).

    With ``bf16``: each model's full block alone, under the cap of
    predicted / CHUNK_MARGIN only (it must fit)."""
    import gc

    import numpy as np
    import torch

    from octseg_torch.core.config import load_config
    from octseg_torch.core.registry import CLASS_IDS
    from octseg_torch.data.utils import postprocess_masks
    from octseg_torch.infer.engine import CHUNK_MARGIN, InferenceEngine
    from octseg_torch.infer.predict import load_pullback_frames

    cfg = load_config('predict')
    block, classes = int(cfg.block_size), list(cfg.classes)
    frames = load_pullback_frames(main['dcm'])
    frames = np.tile(frames, (-(-block // frames.shape[0]), 1, 1, 1))[:block]
    total = torch.cuda.get_device_properties(0).total_memory
    out = (MAIN_OUT, MAIN_OUT)

    def run(run_classes, n):
        engine = InferenceEngine(main['models'], run_classes, block_size=block,
                                 output_resize=str(cfg.get('output_resize', 'prob_bilinear')),
                                 device='cuda', bf16=bf16)
        gc.collect()
        torch.cuda.empty_cache()
        blocks = [m.shape[0] for _s, m in engine.iter_pullback(frames[:n], out)]   # probes
        if blocks != [n]:
            raise AssertionError(f'expected one block of {n} frames, got {blocks}')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        masks = [m for _s, m in engine.iter_pullback(frames[:n], out)][0]
        rec = {'frames': n, 'seconds': time.perf_counter() - t,
               'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
               'peak_reserved_bytes': torch.cuda.max_memory_reserved(),
               'plans': {key[0]: plan._asdict() for key, plan in engine.chunk_plans.items()}}
        if rec['peak_reserved_bytes'] >= total:
            raise AssertionError(f'{run_classes}: peak {rec} over the card\'s {total} bytes')
        return rec, masks, engine

    def capped(engine, n, predicted, ratio, must_fit):
        """The block's peak allocation with the allocator capped at
        ``predicted / ratio``; None when it runs out of memory."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(min(1.0, predicted / ratio / total))
        torch.cuda.reset_peak_memory_stats()
        try:
            list(engine.iter_pullback(frames[:n], out))
            return torch.cuda.max_memory_allocated()
        except torch.OutOfMemoryError:
            if must_fit:
                raise
            return None
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)

    records = {'block_size': block, 'device_total_bytes': total, 'bf16': bf16, 'models': {}}
    ratios = (CHUNK_MARGIN,) if bf16 else (CHUNK_MARGIN, 0.8)
    for name, model_classes, arch, encoder, size in ENSEMBLE:
        records['models'][name] = {'model': f'{arch}/{encoder}', 'input_size': size}
        for n in (block,) if bf16 else (block, MAIN_FRAMES):
            rec, _, engine = run(model_classes, n)
            plan = rec['plans'][name]
            if plan['bytes_per_frame'] is None:
                raise AssertionError(f'{name}: the engine chose its chunk without a probe')
            for ratio in ratios:
                rec[f'peak_allocated_bytes_capped_at_{ratio}'] = capped(
                    engine, n, plan['predicted_peak_bytes'], ratio, ratio == CHUNK_MARGIN)
            del engine
            records['models'][name][str(n)] = rec
            caps = [rec.get(f'peak_allocated_bytes_capped_at_{r}') for r in (CHUNK_MARGIN, 0.8)]
            log(f'one {n}-frame block, {name} {arch}/{encoder} at {size} '
                f'{"bf16" if bf16 else "fp32"}: chunk '
                f'{plan["chunk"]}, {plan["bytes_per_frame"] / 2**20:.1f} MiB per frame fitted; '
                f'peak allocated predicted {plan["predicted_peak_bytes"] / 2**30:.2f} GiB, '
                f'measured {rec["peak_allocated_bytes"] / 2**30:.2f} GiB (reserved '
                f'{rec["peak_reserved_bytes"] / 2**30:.2f} GiB) of {total / 2**30:.2f} GiB; '
                f'budget {plan["budget_bytes"] / 2**30:.2f} GiB; {rec["seconds"]:.2f} s '
                f'({n / rec["seconds"]:.1f} frames/s, forward and bit expansion); peak allocated '
                f'capped at predicted / {CHUNK_MARGIN}: {caps[0] / 2**30:.2f} GiB, at predicted '
                f'/ 0.8: ' + ('not run' if bf16 else 'out of memory' if caps[1] is None
                              else f'{caps[1] / 2**30:.2f} GiB'))
            gc.collect()
    if bf16:
        return records
    rec, masks, _engine = run(classes, block)
    records['ensemble'] = rec
    # the render's postprocess on this block: (frames x classes, H, W)
    sel = masks[..., [CLASS_IDS[c] - 1 for c in classes]]
    m = torch.from_numpy(np.ascontiguousarray(sel.transpose(0, 3, 1, 2))).reshape(
        -1, *out).cuda()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    fill, ring = postprocess_masks(m)
    torch.cuda.synchronize()
    k1 = {'masks': list(m.shape), 'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
          'reserved_before_bytes': reserved,
          'peak_reserved_bytes': torch.cuda.max_memory_reserved()}
    del fill, ring, m
    records['k1_on_block'] = k1
    log(f'one {block}-frame block, the ensemble over {classes}: {rec["seconds"]:.2f} s; peak '
        f'allocated {rec["peak_allocated_bytes"] / 2**30:.2f} GiB, reserved '
        f'{rec["peak_reserved_bytes"] / 2**30:.2f} GiB; chunks '
        f'{ {k: v["chunk"] for k, v in rec["plans"].items()} }; K1 on {k1["masks"]}: peak '
        f'allocated {k1["peak_allocated_bytes"] / 2**30:.2f} GiB, reserved '
        f'{k1["reserved_before_bytes"] / 2**30:.2f} -> {k1["peak_reserved_bytes"] / 2**30:.2f} GiB')
    if k1['peak_allocated_bytes'] > rec['peak_allocated_bytes']:
        raise AssertionError('the postprocess buffers of a block outgrow its forwards\' peak: '
                             'the engine\'s chunk budget must count them')
    return records


def probabilities(engine, name, frames, out_size, chunk: int = 8):
    """The engine's pre-threshold probabilities for one model on its device
    (the pullback variant's preprocessing and output resize), (N, C, H, W)
    float32 on the host."""
    import torch

    from octseg_torch.infer.engine import fp32_exact
    from octseg_torch.ops.normalize import normalize_imagenet
    from octseg_torch.ops.resize import resize_bilinear_nchw, resize_nearest_nchw

    model, cfg = engine._bundle(name)
    s = cfg['input_size']
    resize = (resize_bilinear_nchw if engine.output_resize == 'prob_bilinear'
              else resize_nearest_nchw)
    outs = []
    with torch.inference_mode(), fp32_exact():
        for i in range(0, frames.shape[0], chunk):
            x = torch.from_numpy(frames[i:i + chunk]).to(engine.device)
            x = resize_bilinear_nchw(x.flip(-1).float().permute(0, 3, 1, 2), (s, s))
            x = x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x
            if cfg.get('normalize', False):
                x = normalize_imagenet(x, channel_dim=1)
            outs.append(resize(torch.sigmoid(model(x.contiguous())), out_size).cpu())
    return torch.cat(outs).numpy()


def soften_heads(models: str) -> None:
    """Scale each model dir's head kernel by 1/20 and draw its bias from
    N(0, 0.5). With random weights on the reference's 0..255 inputs the
    models saturate (|logit| about 40): bilinear weights of exactly 1/2
    between p = 0 and p = 1 then put pixels at p = 0.5, and LinkNet's pixels
    whose last ReLU features are all 0 have a logit of exactly the zero bias;
    either fills the near-0.5 share the routing check caps."""
    import numpy as np

    from octseg_torch.train.checkpoint import load_weights, save_weights

    for seed, (name, *_rest) in enumerate(ENSEMBLE):
        path = os.path.join(models, name, 'weights.ckpt')
        variables = load_weights(path)
        head = variables['params']['head']['Conv_0']
        head['kernel'] = head['kernel'] / 20
        head['bias'] = np.random.default_rng(seed).normal(0, 0.5, head['bias'].shape).astype(
            np.float32)
        save_weights(path, variables['params'], variables['batch_stats'])


def routing(tmp: str):
    """The three ensemble families at 64 px over all four classes, GPU
    against CPU, in both output modes."""
    import numpy as np

    from octseg_torch.infer.engine import MODELS_META, InferenceEngine

    models = make_ensemble(os.path.join(tmp, 'small'), size_of=lambda name: 64)
    soften_heads(models)
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
    """Each ensemble model's logits on the pullback's first 2 frames at its
    input size, GPU (TF32 off) against CPU, within LOGITS_ATOL."""
    import numpy as np
    import torch

    from octseg_torch.data import dicom
    from octseg_torch.infer.engine import fp32_exact, load_model_bundle
    from octseg_torch.ops.normalize import normalize_imagenet
    from octseg_torch.ops.resize import resize_bilinear_nchw

    frames = torch.from_numpy(np.array(dicom.dcmread(main['dcm']).pixel_array[:2])).float()
    record = {}
    for name, classes, arch, encoder, size in ENSEMBLE:
        x = resize_bilinear_nchw(frames[:, None], (size, size)).expand(-1, 3, -1, -1)
        x = normalize_imagenet(x, channel_dim=1).contiguous()
        out = {}
        for device in ('cuda', 'cpu'):
            model, _cfg = load_model_bundle(os.path.join(main['models'], name), device)
            with torch.inference_mode(), fp32_exact():
                if device == 'cuda':
                    log(f'cudnn allow_tf32 in the forward: {torch.backends.cudnn.allow_tf32}')
                out[device] = model(x.to(device)).float().cpu()
            del model
        err = float((out['cuda'] - out['cpu']).abs().max())
        scale = float(out['cpu'].abs().max())
        log(f'{name} {arch}/{encoder} logits {tuple(out["cpu"].shape)} GPU vs CPU: max |delta| '
            f'{err:.3g} (max |logit| {scale:.3g}), bound {LOGITS_ATOL}')
        if not err <= LOGITS_ATOL:
            raise AssertionError(f'{name}: GPU and CPU logits differ by {err}')
        record[name] = {'max_abs_delta': err, 'max_abs_logit': scale}
    return record


def train_path(tmp: str, bf16: bool = False):
    """The training path at full width: configs/train.yaml's Unet/resnet50
    at 512, batch 4, four classes, Adam, augmentation on, two epochs over a
    synthetic fold of 1000 px frames (made by the first call); with
    ``bf16``, ``bf16=true``."""
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
    if not os.path.isdir(fold):
        t = time.perf_counter()
        make_synth_fold(fold, n_train, n_test, size=TRAIN_FRAME_PX, seed=11, n_vis=n_vis)
        log(f'synthetic fold ({n_train}/{n_test}/{n_vis} at {TRAIN_FRAME_PX} px) written in '
            f'{time.perf_counter() - t:.1f} s')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    t = time.perf_counter()
    save_dir = os.path.join(tmp, 'train_bf16' if bf16 else 'train')
    summary = train(overrides=[f'data_dir={fold}', f'save_dir={save_dir}', 'epochs=2']
                    + (['bf16=true'] if bf16 else []))
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
                               int(manifest['batch_size']), bf16)
    secs = summary['seconds']
    loop = secs['data_wait'] + secs['train']
    record = {'model': f'{manifest["architecture"]}/{manifest["encoder"]}', 'bf16': bf16,
              'input_size': manifest['input_size'], 'batch_size': manifest['batch_size'],
              'train_steps': steps, 'train_samples': summary['train_samples'],
              'samples_per_s': summary['train_samples'] / loop, 'seconds': secs,
              'data_wait_share': secs['data_wait'] / loop, 'wall_s': wall,
              'peak_allocated_bytes': peak, 'launches': launches,
              'best_val_loss': summary['best_val_loss'], 'step': breakdown,
              'model_dir': model_dir, 'fold': fold}
    log(f'training path ({"bf16" if bf16 else "fp32"}): {record["model"]} at '
        f'{record["input_size"]}, batch '
        f'{record["batch_size"]}: {steps} steps, {record["samples_per_s"]:.2f} samples/s in '
        f'the train loop, data-wait share {record["data_wait_share"]:.3f}; seconds per stage '
        f'{json.dumps({k: round(v, 3) for k, v in secs.items()})}; {wall:.1f} s in main(); '
        f'device memory peak {peak / 2**30:.2f} GiB; launches {launches}; best val loss '
        f'{summary["best_val_loss"]:.4f}')
    return record


def step_breakdown(torch, arch: str, encoder: str, classes: int, size: int, batch: int,
                   bf16: bool = False):
    """One training step at the training path's shapes without the loader:
    its time (CUDA events, median of 10), the augmentation's alone, and a
    profiler trace of 3 steps: device busy time by kernel and the idle share
    of the device over those steps' wall time (1 - busy / wall)."""
    from torch.profiler import ProfilerActivity, profile

    from octseg_torch.models import create_model
    from octseg_torch.ops.augment import augment_batch
    from octseg_torch.train.state import TrainState, make_optimizer
    from octseg_torch.train.train import init_model, make_train_step

    dtype = torch.bfloat16 if bf16 else torch.float32
    model = init_model(create_model(arch, encoder, classes=classes, dtype=dtype), 0).cuda()
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
    log(f'one training step ({arch}/{encoder} at {size}, batch {batch}, '
        f'{"bf16" if bf16 else "fp32"}, augmentation on): '
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


def remat_step():
    """One training step of configs/train.yaml's Unet/resnet50 at 512, batch
    4, four classes, augmentation on, with remat on and off, from the same
    weights, batch and generator seed: the worst parameter's relative L2
    gradient gap within REMAT_GRAD_GAP, the BatchNorm running statistics
    within BN_STATS_ATOL, the loss equal to 1e-6 relative; the memory peak
    of each."""
    import copy

    import numpy as np
    import torch

    from octseg_torch.infer.engine import fp32_exact
    from octseg_torch.models import create_model
    from octseg_torch.models.remat import set_block_remat
    from octseg_torch.ops.augment import augment_batch
    from octseg_torch.train.train import _loss_and_logits, init_model

    base = init_model(create_model('Unet', 'resnet50', classes=4), seed=0)
    gen = torch.Generator(device='cuda').manual_seed(1)
    imgs = torch.rand((4, 512, 512, 3), device='cuda', generator=gen) * 255.0
    masks = (torch.rand((4, 512, 512, 4), device='cuda', generator=gen) > 0.6).float()
    out = {}
    for remat in (False, True):
        model = set_block_remat(copy.deepcopy(base), remat).cuda().train()
        gen.manual_seed(7)
        x, y = augment_batch(imgs, masks, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with fp32_exact():
            loss, _, _ = _loss_and_logits(model, x, y)
            loss.backward()
        torch.cuda.synchronize()
        out[remat] = (float(loss.detach()),
                      {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()},
                      {k: b.double().cpu().numpy() for k, b in model.named_buffers()},
                      torch.cuda.max_memory_allocated() - before)
        del model, loss
    (loss, grads, stats, peak), (rloss, rgrads, rstats, rpeak) = out[False], out[True]
    gaps = {k: float(np.linalg.norm(rgrads[k] - grads[k]) / max(np.linalg.norm(grads[k]),
                                                                1e-30)) for k in grads}
    worst = max(gaps, key=gaps.get)
    stats_gap = max(float(np.abs(rstats[k] - stats[k]).max()) for k in stats)
    record = {'loss': loss, 'loss_remat': rloss, 'grad_worst_rel_gap': gaps[worst],
              'grad_worst_param': worst, 'bn_stats_max_abs_gap': stats_gap,
              'step_peak_bytes': peak, 'step_peak_bytes_remat': rpeak}
    log(f'remat against plain, one fp32 step of Unet/resnet50 at 512, batch 4: loss {loss:.6f} '
        f'vs {rloss:.6f}; worst relative gradient gap {gaps[worst]:.3g} ({worst}), bound '
        f'{REMAT_GRAD_GAP}; BatchNorm statistics max |delta| {stats_gap:.3g}, bound '
        f'{BN_STATS_ATOL}; step memory peak above the model {peak / 2**30:.2f} GiB plain, '
        f'{rpeak / 2**30:.2f} GiB with remat')
    if (gaps[worst] > REMAT_GRAD_GAP or stats_gap > BN_STATS_ATOL
            or abs(loss - rloss) > 1e-6 * abs(loss)):
        raise AssertionError(f'remat and plain steps disagree: {record}')
    return record


def b7_step_memory():
    """The device memory peak of one bf16 training step of LinkNet/
    efficientnet-b7 at 896, batch 4, two classes (FC_LC's), augmentation on,
    Adam, with and without remat; the losses must be finite."""
    import math

    import torch

    from octseg_torch.models import create_model
    from octseg_torch.train.state import TrainState, make_optimizer
    from octseg_torch.train.train import init_model, make_train_step

    gen = torch.Generator(device='cuda').manual_seed(2)
    imgs = torch.rand((4, 896, 896, 3), device='cuda', generator=gen) * 255.0
    masks = (torch.rand((4, 896, 896, 2), device='cuda', generator=gen) > 0.6).float()
    record = {}
    for remat in (False, True):
        key = 'remat' if remat else 'plain'
        torch.cuda.empty_cache()
        model = init_model(create_model('LinkNet', 'efficientnet-b7', classes=2,
                                        dtype=torch.bfloat16, remat=remat), 0).cuda()
        state = TrainState.create(model, make_optimizer('Adam', 1e-5))
        step = make_train_step(use_augmentation=True)
        try:
            step(state, imgs, masks, gen)     # optimizer state allocated
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = float(step(state, imgs, masks, gen)['loss'])
            torch.cuda.synchronize()
            record[key] = {'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
                           'step_s': time.perf_counter() - t, 'loss': loss}
        except torch.OutOfMemoryError:
            if remat:
                raise
            record[key] = {'peak_allocated_bytes': None, 'out_of_memory': True}
            loss = 0.0
        del state, model, step
        torch.cuda.empty_cache()
        if not math.isfinite(loss):
            raise AssertionError(f'bf16 LinkNet/efficientnet-b7 step ({key}): loss {loss}')

    def peak(key):
        rec = record[key]
        if rec['peak_allocated_bytes'] is None:
            return 'out of memory'
        return f'{rec["peak_allocated_bytes"] / 2**30:.2f} GiB ({rec["step_s"]:.3f} s)'

    log('one bf16 training step of LinkNet/efficientnet-b7 at 896, batch 4: device memory peak '
        f'{peak("plain")} plain, {peak("remat")} with remat')
    return record


def jpeg_decode():
    """The C++ entropy decoder against its plain Python version on every
    fixture file (the pullback's 16 frames and the small JPEGs), bit-exact;
    ms per frame of each, from the whole decode (parse, entropy, IDCT,
    upsampling, colour), the pullback's frames only."""
    import numpy as np

    from octseg_torch.data import dicom
    from octseg_torch.data.jpeg import decode_jpeg

    frames = list(dicom.dcmread(os.path.join(JPEG_FIXTURE, 'pullback.dcm')).PixelData)
    small = {}
    for name in sorted(os.listdir(JPEG_FIXTURE)):
        if name.endswith('.jpg'):
            with open(os.path.join(JPEG_FIXTURE, name), 'rb') as f:
                small[name] = f.read()
    record = {'frames': len(frames), 'small_files': sorted(small)}
    for label, native in (('native', True), ('python', False)):
        t = time.perf_counter()
        record[label] = [decode_jpeg(f, native=native) for f in frames]
        record[f'{label}_ms_per_frame'] = (time.perf_counter() - t) * 1e3 / len(frames)
    for k, (a, b) in enumerate(zip(record.pop('native'), record.pop('python'))):
        if a.shape != (704, 704, 3) or not np.array_equal(a, b):
            raise AssertionError(f'pullback frame {k}: C++ and Python entropy decoders differ')
    for name, data in small.items():
        if not np.array_equal(decode_jpeg(data), decode_jpeg(data, native=False)):
            raise AssertionError(f'{name}: C++ and Python entropy decoders differ')
    log(f'JPEG decode: {len(frames)} 704x704 4:2:0 frames and {len(small)} small files '
        f'bit-exact C++ against Python; {record["native_ms_per_frame"]:.2f} ms per frame with '
        f'the C++ entropy decoder, {record["python_ms_per_frame"]:.2f} ms with the Python one')
    return record


def run_predict(overrides, out: str, n_images: int, label: str):
    """``predict.main`` with ``overrides`` (a user's command line) from
    launch counts of 0: every image's two PNGs at MAIN_OUT must be written
    and K1 must launch. Returns its record."""
    import torch

    from octseg_torch.infer.predict import main as predict
    from octseg_torch.ops.kernels import postprocess as k1
    from octseg_torch.ops.kernels import warp as k2

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    result = predict(overrides=list(overrides) + [f'save_dir={out}',
                                                  f'output_size=[{MAIN_OUT},{MAIN_OUT}]',
                                                  'device=cuda'])
    launches, peak = k1.launches, torch.cuda.max_memory_allocated()
    pngs = sorted(f for f in os.listdir(out) if f.endswith('.png'))
    if result['frames'] != n_images or len(pngs) != 2 * n_images:
        raise AssertionError(f'{label}: {result["frames"]} images, {len(pngs)} PNGs')
    for f in pngs:
        if png_size(os.path.join(out, f)) != (MAIN_OUT, MAIN_OUT):
            raise AssertionError(f'{label}: {f} is not {MAIN_OUT}x{MAIN_OUT}')
    if launches < 1:
        raise AssertionError(f'{label}: K1 never launched')
    secs = result['seconds']
    record = {'frames': result['frames'], 'seconds': secs, 'chunks': result['chunks'],
              'k1_launches': launches, 'k2_launches': k2.launches,
              'frames_per_s': result['frames'] / secs['total'], 'peak_allocated_bytes': peak}
    log(f'{label}: {result["frames"]} images, {launches} K1 launch(es), '
        f'{record["frames_per_s"]:.2f} frames/s end to end; seconds per stage '
        f'{json.dumps({k: round(v, 3) for k, v in secs.items()})}; chunks {result["chunks"]}; '
        f'device memory peak {peak / 2**30:.2f} GiB')
    return record


def jpeg_pullback(tmp: str, main):
    """The fixture's JPEG Baseline pullback (16 704x704 4:2:0 colour frames)
    through the full ensemble, configs/predict.yaml's classes and block."""
    out = os.path.join(tmp, 'predict_jpeg')
    return run_predict([f'data_dir={os.path.join(JPEG_FIXTURE, "pullback.dcm")}',
                        f'models_dir={main["models"]}'], out, 16, 'JPEG pullback predict')


def image_directory(tmp: str, main):
    """The image-directory path at full width: IMAGE_DIR_PNGS RGB PNGs at
    MAIN_OUT written by the port's write_png, and 8 of the fixture's JPEG
    frames as .jpg files, through the full ensemble."""
    import numpy as np

    from octseg_torch.data import dicom
    from octseg_torch.data.image import write_png

    images = os.path.join(tmp, 'images')
    os.makedirs(images)
    frames = synthetic_pullback(IMAGE_DIR_PNGS, MAIN_OUT, 7)
    for k, frame in enumerate(frames):
        write_png(os.path.join(images, f'png_{k:02d}.png'),
                  np.stack([frame, (0.8 * frame).astype(np.uint8), frame // 2], -1))
    fragments = dicom.dcmread(os.path.join(JPEG_FIXTURE, 'pullback.dcm')).PixelData
    for k, frag in enumerate(fragments[:8]):
        with open(os.path.join(images, f'jpg_{k:02d}.jpg'), 'wb') as f:
            f.write(frag)
    return run_predict([f'data_dir={images}', f'models_dir={main["models"]}'],
                       os.path.join(tmp, 'predict_images'), IMAGE_DIR_PNGS + 8,
                       'image-directory predict')


def bf16_predict(tmp: str, main):
    """The 32-frame main-path pullback with ``bf16=true`` against fp32 on
    the ensemble with softened heads: per class, the share of pixels whose
    masks differ away from p = 0.5 (the fp32 probability at least BF16_BAND
    from it) within BF16_MASK_SHARE; then the predict path itself with
    bf16=true for its frames/s, chunks and memory peak beside fp32's."""
    import numpy as np

    from octseg_torch.core.config import load_config
    from octseg_torch.infer.engine import InferenceEngine
    from octseg_torch.infer.predict import load_pullback_frames

    models = make_ensemble(os.path.join(tmp, 'soft'))
    soften_heads(models)
    cfg = load_config('predict')
    classes = list(cfg.classes)
    frames = load_pullback_frames(main['dcm'])
    out = (MAIN_OUT, MAIN_OUT)
    masks, engines = {}, {}
    for bf16 in (False, True):
        engines[bf16] = InferenceEngine(models, classes, block_size=int(cfg.block_size),
                                        device='cuda', bf16=bf16)
        masks[bf16] = engines[bf16].segment_pullback(frames, out)
    record = {'band': BF16_BAND, 'bound': BF16_MASK_SHARE, 'classes': {}}
    for name, routes in engines[False]._ensemble_plan().items():
        p32 = probabilities(engines[False], name, frames, out)
        p16 = probabilities(engines[True], name, frames, out)
        for cls, ch, mask_ch in routes:
            differ = masks[False][..., mask_ch] != masks[True][..., mask_ch]
            away = np.abs(p32[:, ch] - 0.5) >= BF16_BAND
            rec = {'differing_share': float(differ.mean()),
                   'differing_share_away': float((differ & away).mean()),
                   'near_share': float((~away).mean()),
                   'positive_share_fp32': float(masks[False][..., mask_ch].mean()),
                   'max_abs_prob_delta': float(np.abs(p16[:, ch] - p32[:, ch]).max())}
            record['classes'][cls] = rec
            log(f'bf16 vs fp32, {cls} ({name}): {rec["differing_share"]:.3e} of pixels differ, '
                f'{rec["differing_share_away"]:.3e} with the fp32 probability at least '
                f'{BF16_BAND} from 0.5 (bound {BF16_MASK_SHARE}); {rec["near_share"]:.3e} within '
                f'it; max |p_bf16 - p_fp32| {rec["max_abs_prob_delta"]:.3g}; positive share '
                f'{rec["positive_share_fp32"]:.4f}')
    del engines
    bad = {c: r['differing_share_away'] for c, r in record['classes'].items()
           if r['differing_share_away'] > BF16_MASK_SHARE}
    if bad:
        raise AssertionError(f'bf16 masks differ from fp32 beyond the bound: {bad}')
    record['predict'] = run_predict([f'data_dir={main["dcm"]}', f'models_dir={main["models"]}',
                                     'bf16=true'], os.path.join(tmp, 'predict_bf16'),
                                    MAIN_FRAMES, 'bf16 predict path')
    return record


def post_pullback(url: str, body: bytes, fmt: str):
    """POST a pullback to the service: (NDJSON records or the quant payload,
    seconds to the first block record (None for quant), seconds to the end)."""
    import urllib.request

    t = time.perf_counter()
    req = urllib.request.Request(f'{url}/v1/pullback' + ('?format=quant' if fmt == 'quant'
                                                         else ''), data=body, method='POST')
    first = None
    with urllib.request.urlopen(req, timeout=600) as resp:
        if fmt == 'quant':
            out = json.loads(resp.read())
        else:
            out = []
            for line in resp:
                out.append(json.loads(line))
                if first is None and out[-1]['type'] == 'block':
                    first = time.perf_counter() - t
    return out, first, time.perf_counter() - t


def serve_path(tmp: str, main, models: str):
    """The inference service at full width: configs/serve.yaml unchanged
    (bf16, block 128, four classes, 1000x1000) over the three winners
    (softened heads, so that masks hold both values), in process on
    127.0.0.1 with port 0. The 32-frame main-path pullback in
    ``format=masks`` twice (cold: model loads and probes; warm), each block
    decoded and held to the server engine's ``segment_pullback``
    (differences only where the probability is within 1e-4 of 0.5, counted);
    ``format=quant`` held to ``quantify_blocks`` over those masks with the
    Python tracer, and the C++ and Python tracers equal on every channel
    that counts (ms per mask of each); the port's client in masks mode (K1
    once per streamed block) against a local ``predict.main`` with
    bf16=true, PNGs byte-identical; a 503 with Retry-After while the
    admission semaphore is held; /healthz and /metrics."""
    import urllib.error
    import urllib.request

    import numpy as np

    from octseg_torch.analyze.contours import find_external_contours
    from octseg_torch.core.config import Config, load_config
    from octseg_torch.core.registry import CLASS_IDS
    from octseg_torch.infer import client
    from octseg_torch.infer.engine import fp32_exact
    from octseg_torch.infer.predict import load_pullback_frames
    from octseg_torch.infer.serve import decode_block, quantify_blocks, serve
    from octseg_torch.ops.kernels import postprocess as k1

    if not os.path.isdir(models):
        raise AssertionError(f'{models}: the softened ensemble is made by the bf16 phase')
    cfg = load_config('serve', [f'models_dir={models}', 'port=0'])
    if (cfg.bf16, cfg.block_size, cfg.output_size, len(cfg.classes)) != (True, 128,
                                                                         [1000, 1000], 4):
        raise AssertionError(f'configs/serve.yaml is not the one this phase measures: {cfg}')
    out = tuple(cfg.output_size)
    httpd = serve(cfg, block=False)
    try:
        state = httpd.octseg_state
        url = 'http://%s:%d' % httpd.server_address[:2]
        with open(main['dcm'], 'rb') as f:
            body = f.read()
        frames = load_pullback_frames(main['dcm'])
        n = frames.shape[0]
        record = {'frames': n, 'output_size': list(out), 'classes': list(cfg.classes)}
        for label in ('cold', 'warm'):
            lines, first, total = post_pullback(url, body, 'masks')
            if [ln['type'] for ln in lines] != ['header', 'block', 'end']:
                raise AssertionError(f'masks stream: {[ln["type"] for ln in lines]}')
            record[f'{label}_first_block_s'] = first
            record[f'{label}_frames_per_s'] = n / total
            log(f'serve masks ({label}): {n} frames in {total:.3f} s ({n / total:.2f} frames/s), '
                f'first block after {first:.3f} s')
        header, block = lines[0], lines[1]
        streamed = decode_block(block, block['count'], header['height'], header['width'])
        with state.device(), fp32_exact():
            want = state.engine.segment_pullback(frames, out)
            near = np.zeros_like(want, bool)
            for name, routes in state.engine._ensemble_plan().items():
                p = probabilities(state.engine, name, frames, out)
                for _cls, ch, mask_ch in routes:
                    near[..., mask_ch] = np.abs(p[:, ch] - 0.5) < 1e-4
        differ = streamed != want
        record.update(differing_px=int(differ.sum()), near_half_px=int(near.sum()),
                      mask_px=int(differ.size))
        log(f'serve masks against the engine: {record["differing_px"]} differing px of '
            f'{differ.size}, {record["near_half_px"]} within 1e-4 of p = 0.5')
        if (differ & ~near).any():
            raise AssertionError('served masks differ from the engine away from p = 0.5')

        payload, _, quant_s = post_pullback(url, body, 'quant')
        record['quant_s'] = quant_s
        channels = [streamed[j, :, :, CLASS_IDS[c] - 1].astype(np.uint8) * 255
                    for j in range(n) for c in cfg.classes]
        counting = [ch for ch in channels if ch.any() and not ch.all()]
        times = {'cpp': [], 'python': []}
        for ch in counting:
            got = {}
            for label, native in (('cpp', True), ('python', False)):
                t = time.perf_counter()
                got[label] = find_external_contours(ch, native=native)
                times[label].append(time.perf_counter() - t)
            if len(got['cpp']) != len(got['python']) or not all(
                    np.array_equal(a, b) for a, b in zip(got['cpp'], got['python'])):
                raise AssertionError('the C++ and Python contour tracers differ')
        if not counting:
            raise AssertionError('no channel of the served masks holds both values')
        record.update(counting_channels=len(counting), channels=len(channels),
                      contour_ms_cpp=1e3 * float(np.mean(times['cpp'])),
                      contour_ms_python=1e3 * float(np.mean(times['python'])))
        python_payload = json.loads(json.dumps(quantify_blocks(
            [(0, streamed)], n, cfg.classes, out, native=False)))
        if payload != python_payload:
            raise AssertionError('the quant payload differs from quantify_blocks with the '
                                 'Python tracer over the streamed masks')
        rows = {c: len(o['slice']) for c, o in payload['objects'].items()}
        log(f'serve quant: {quant_s:.3f} s per {n} frames; rows per class {rows}; C++ and '
            f'Python tracers equal on all {len(counting)} counting channels of {len(channels)}; '
            f'{record["contour_ms_cpp"]:.3f} ms per 1000x1000 mask with the C++ tracer, '
            f'{record["contour_ms_python"]:.3f} ms with the Python one')
        record['quant_rows'] = rows

        render_s = [0.0]
        save_block = client.save_block

        def timed(*args, **kwargs):
            t = time.perf_counter()
            save_block(*args, **kwargs)
            render_s[0] += time.perf_counter() - t

        client.save_block = timed
        try:
            k1.launches = 0
            t = time.perf_counter()
            done = client.run(Config(server_url=url, dcm_path=main['dcm'],
                                     save_dir=os.path.join(tmp, 'client'), format='masks',
                                     classes=list(cfg.classes)))
            record['client_s'] = time.perf_counter() - t
            record['k1_launches'] = k1.launches
        finally:
            client.save_block = save_block
        record['client_render_s'] = render_s[0]
        if done != n or record['k1_launches'] < 1:
            raise AssertionError(f'client: {done} frames, {record["k1_launches"]} K1 launches')
        local = run_predict([f'data_dir={main["dcm"]}', f'models_dir={models}', 'bf16=true'],
                            os.path.join(tmp, 'serve_local'), n, 'serve: local bf16 predict')
        names = sorted(os.listdir(os.path.join(tmp, 'client')))
        if names != sorted(os.listdir(os.path.join(tmp, 'serve_local'))) or len(names) != 2 * n:
            raise AssertionError('the client and the local predict wrote different files')
        unequal = []
        for name in names:
            with open(os.path.join(tmp, 'client', name), 'rb') as a, \
                    open(os.path.join(tmp, 'serve_local', name), 'rb') as b:
                if a.read() != b.read():
                    unequal.append(name)
        if unequal:
            raise AssertionError(f'client PNGs differ from the local predict: {unequal[:6]}')
        record['local_predict_s'] = local['seconds']['total']
        log(f'serve client (masks): {done} frames in {record["client_s"]:.3f} s, render '
            f'{record["client_render_s"]:.3f} s, {record["k1_launches"]} K1 launch(es); all '
            f'{len(names)} PNGs byte-identical to the local predict')

        # one job on the device and max_queued waiting: every slot is taken
        slots = 1 + int(cfg.max_queued)
        if not all(state.admit() for _ in range(slots)):
            raise AssertionError('the admission semaphore has fewer free slots than configured')
        try:
            post_pullback(url, body, 'masks')
            raise AssertionError('a POST while the admission semaphore is held was served')
        except urllib.error.HTTPError as e:
            if e.code != 503 or e.headers['Retry-After'] != '10':
                raise
        finally:
            for _ in range(slots):
                state.release()
        with urllib.request.urlopen(f'{url}/healthz', timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f'{url}/metrics', timeout=60) as r:
            metrics = r.read().decode()
        if health['platform'] != 'gpu' or health['models'] != ['FC_LC', 'LM', 'VV']:
            raise AssertionError(f'/healthz: {health}')
        for series in ('octseg_requests_total{endpoint="pullback",status="200"} 4',
                       'octseg_requests_total{endpoint="pullback",status="503"} 1',
                       f'octseg_frames_total {4 * n}', 'octseg_rejected_total 1'):
            if series not in metrics.splitlines():
                raise AssertionError(f'/metrics lacks {series!r}:\n{metrics}')
        record['health'] = health
        log(f'serve: 503 with Retry-After while held; /healthz {health}; /metrics counts 4 '
            f'pullbacks and 1 rejection')
        return record
    finally:
        httpd.shutdown()
        httpd.server_close()


# GPU against CPU evaluation of the training path's model (bound stated in
# PERF.md before the first run): each metric of each class within EVAL_ATOL,
# and each (sample, class) mask with no probability within 1e-4 of 0.5
# equal on both devices
EVAL_ATOL = 1e-3


def evaluate_path(train):
    """configs/evaluate.yaml's entry point on the training path's model dir
    (Unet/resnet50 at 512, four classes) and its fold's test split on the
    card, and ``evaluate_model`` on the CPU; the split's masks on both
    devices, compared away from p = 0.5."""
    import numpy as np
    import torch

    from octseg_torch.infer.engine import fp32_exact, load_model_bundle
    from octseg_torch.ops.normalize import normalize_imagenet, sigmoid_threshold
    from octseg_torch.train.data import OCTDataset
    from octseg_torch.train.evaluate import evaluate_model
    from octseg_torch.train.evaluate import main as evaluate

    model_dir, fold = train['model_dir'], train['fold']
    t = time.perf_counter()
    gpu = evaluate(overrides=[f'model_dir={model_dir}', f'data_dir={fold}', 'device=cuda'])
    gpu_s = time.perf_counter() - t
    if not os.path.isfile(os.path.join(model_dir, 'eval_test.json')):
        raise AssertionError('evaluate wrote no eval_test.json')
    t = time.perf_counter()
    cpu = evaluate_model(model_dir, fold, device='cpu')
    cpu_s = time.perf_counter() - t
    probs, masks = {}, {}
    for device in ('cuda', 'cpu'):
        model, cfg = load_model_bundle(model_dir, device)
        data = OCTDataset(os.path.join(fold, 'test'), cfg['classes'], cfg['input_size'])
        imgs = torch.from_numpy(np.stack([data.load(i)[0] for i in range(len(data))]))
        with torch.inference_mode(), fp32_exact():
            x = normalize_imagenet(imgs.to(device)).permute(0, 3, 1, 2).contiguous()
            logits = model(x)
            # evaluate's masks: the logits' sign
            masks[device] = sigmoid_threshold(logits).cpu().numpy()
            probs[device] = torch.sigmoid(logits).float().cpu().numpy()
        del model
    near = (np.abs(probs['cpu'] - 0.5) < 1e-4).any(axis=(2, 3))          # (N, C)
    differ = (masks['cuda'] != masks['cpu']).any(axis=(2, 3))
    gap = max(abs(gpu[c][k] - cpu[c][k]) for c in cpu for k in cpu[c])
    record = {'model_dir_model': f'{cfg["architecture"]}/{cfg["encoder"]}',
              'samples': len(data), 'classes': cfg['classes'], 'gpu': gpu, 'cpu': cpu,
              'max_abs_metric_gap': gap, 'bound': EVAL_ATOL, 'gpu_s': gpu_s, 'cpu_s': cpu_s,
              'masks_near_half': int(near.sum()), 'masks_differing': int(differ.sum()),
              'max_abs_prob_delta': float(np.abs(probs['cuda'] - probs['cpu']).max())}
    log(f'evaluate {record["model_dir_model"]} on {len(data)} test samples: {gpu_s:.2f} s on the '
        f'card, {cpu_s:.2f} s on the CPU; largest metric gap {gap:.3g} (bound {EVAL_ATOL}); '
        f'{record["masks_differing"]} (sample, class) masks differ, {record["masks_near_half"]} '
        f'hold a probability within 1e-4 of 0.5; max |p_gpu - p_cpu| '
        f'{record["max_abs_prob_delta"]:.3g}; Mean dice {gpu["Mean"]["dice"]:.4f}')
    if (differ & ~near).any() or gap > EVAL_ATOL:
        raise AssertionError(f'GPU and CPU evaluation disagree: {record}')
    return record


FOLDS_SPLITS = (8, 4)         # train, test frames of each synthetic fold


def folds_path(tmp: str):
    """``python -m octseg_torch.train.folds``'s main with configs/train.yaml
    (Unet/resnet50 at 512, batch 4, four classes, augmentation on) over two
    synthetic folds of 1000 px frames, one epoch each: folds_summary.csv's
    header and two rows, each fold dir's weights.ckpt, metrics.csv and
    config.json, K2 once per step."""
    import csv

    from octseg_torch.data.synth import make_synth_fold
    from octseg_torch.ops.kernels import warp as k2
    from octseg_torch.train.folds import SUMMARY_FIELDS
    from octseg_torch.train.folds import main as train_folds

    cv_dir = os.path.join(tmp, 'cv')
    n_train, n_test = FOLDS_SPLITS
    t = time.perf_counter()
    for k in (1, 2):
        make_synth_fold(os.path.join(cv_dir, f'fold_{k}'), n_train, n_test, size=TRAIN_FRAME_PX,
                        seed=20 + k)
    log(f'two synthetic folds ({n_train}/{n_test} at {TRAIN_FRAME_PX} px) written in '
        f'{time.perf_counter() - t:.1f} s')
    save_dir = os.path.join(tmp, 'folds')
    k2.launches = 0
    t = time.perf_counter()
    results = train_folds(overrides=[f'cv_dir={cv_dir}', 'folds=[1,2]', f'save_dir={save_dir}',
                                     'epochs=1'])
    wall = time.perf_counter() - t
    launches = k2.launches
    run_dir = os.path.join(save_dir, 'unet_resnet50')
    with open(os.path.join(run_dir, 'folds_summary.csv'), newline='') as f:
        reader = csv.DictReader(f)
        fields, rows = reader.fieldnames, list(reader)
    if fields != SUMMARY_FIELDS or [r['fold'] for r in rows] != ['1', '2']:
        raise AssertionError(f'folds_summary.csv: {fields}, {rows}')
    for k in (1, 2):
        for name in ('weights.ckpt', 'metrics.csv', 'config.json'):
            if not os.path.isfile(os.path.join(run_dir, f'fold_{k}', name)):
                raise AssertionError(f'fold_{k} has no {name}')
    steps = sum(r['train_steps'] for r in results)
    if steps != 2 * (n_train // 4) or launches != steps:
        raise AssertionError(f'{steps} train steps, {launches} K2 launches')
    record = {'folds': len(rows), 'wall_s': wall, 'train_steps': steps, 'k2_launches': launches,
              'summary': rows}
    log(f'folds: 2 folds of train.yaml\'s model, one epoch each, in {wall:.1f} s; '
        f'{steps} steps, {launches} K2 launches; summary {rows}')
    return record


def zoo_logits_gpu_vs_cpu(main):
    """Each ZOO model (random weights from seed k, flax's initialization)
    on the pullback's first ZOO_LOGITS_FRAMES frames at ZOO_LOGITS_PX, GPU
    (TF32 off) against CPU, within LOGITS_ATOL. Random weights give logits
    up to 1e4 (PAN), so after the CPU pass the head's kernel and bias are
    scaled by c = ZOO_LOGIT_SCALE / max |logit| (when below 1) and the GPU's
    logits are held against c times the CPU's: the head and the upsampling
    are linear, so that is the model's error at a logit scale of 10."""
    import numpy as np
    import torch

    from octseg_torch.data import dicom
    from octseg_torch.infer.engine import fp32_exact
    from octseg_torch.models import create_model
    from octseg_torch.ops.normalize import normalize_imagenet
    from octseg_torch.ops.resize import resize_bilinear_nchw
    from octseg_torch.train.train import init_model

    frames = torch.from_numpy(np.array(
        dicom.dcmread(main['dcm']).pixel_array[:ZOO_LOGITS_FRAMES])).float()
    x = resize_bilinear_nchw(frames[:, None], (ZOO_LOGITS_PX, ZOO_LOGITS_PX))
    x = normalize_imagenet(x.expand(-1, 3, -1, -1), channel_dim=1).contiguous()
    record = {}
    for seed, (arch, encoder) in enumerate(ZOO):
        model = init_model(create_model(arch, encoder, classes=1), seed).eval()
        t = time.perf_counter()
        with torch.inference_mode():
            cpu = model(x)
        cpu_s = time.perf_counter() - t
        raw_scale = float(cpu.abs().max())
        c = min(1.0, ZOO_LOGIT_SCALE / raw_scale)
        with torch.no_grad():
            for p in model.segmentation_head.parameters():
                p.mul_(c)
        model.to('cuda')
        with torch.inference_mode(), fp32_exact():
            gpu = model(x.to('cuda')).cpu()
        del model
        torch.cuda.empty_cache()
        err = float((gpu - c * cpu).abs().max())
        log(f'zoo {arch}/{encoder} logits {tuple(cpu.shape)} GPU vs CPU: max |delta| {err:.3g} '
            f'at a head scaled by {c:.3g} (max |logit| {raw_scale:.3g} unscaled), bound '
            f'{LOGITS_ATOL}; CPU forward {cpu_s:.1f} s')
        if not (err <= LOGITS_ATOL and torch.isfinite(gpu).all()):
            raise AssertionError(f'{arch}/{encoder}: GPU and CPU logits differ by {err}')
        record[f'{arch}/{encoder}'] = {'max_abs_delta': err, 'head_scale': c,
                                       'max_abs_logit_unscaled': raw_scale}
    return record


def zoo_train_steps():
    """One fp32 training step of each ZOO model and of ZOO_HEAVIEST at
    configs/tune.yaml's largest input size and batch, augmentation on, Adam,
    after one step that allocates the optimizer state: ms per step and the
    device memory peak. A model that runs out of memory runs again with
    remat, recorded as such. K2 must launch once per step."""
    import gc
    import math

    import torch

    from octseg_torch.core.config import load_config
    from octseg_torch.models import create_model
    from octseg_torch.ops.kernels import warp as k2
    from octseg_torch.train.state import TrainState, make_optimizer
    from octseg_torch.train.train import init_model, make_train_step

    cfg = load_config('tune')
    size, batch, classes = int(cfg.input_size_max), int(cfg.batch_size), len(cfg.classes)
    gen = torch.Generator(device='cuda').manual_seed(3)
    imgs = torch.rand((batch, size, size, 3), device='cuda', generator=gen) * 255.0
    masks = (torch.rand((batch, size, size, classes), device='cuda', generator=gen) > 0.6
             ).float()
    step = make_train_step(use_augmentation=True)
    records, steps = {}, 0
    k2.launches = 0
    for arch, encoder in ZOO + (ZOO_HEAVIEST,):
        name = f'{arch}/{encoder}'
        for remat in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            model = init_model(create_model(arch, encoder, classes=classes, remat=remat),
                               0).to('cuda')
            state = TrainState.create(model, make_optimizer('Adam', 1e-4))
            try:
                steps += 1
                step(state, imgs, masks, gen)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                steps += 1
                loss = float(step(state, imgs, masks, gen)['loss'])
                rec = {'remat': remat, 'ms_per_step': (time.perf_counter() - t) * 1e3,
                       'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
                       'loss': loss}
            except torch.OutOfMemoryError:
                if remat:
                    raise
                records[name + ' plain'] = {'out_of_memory': True}
                log(f'zoo step {name} at {size}, batch {batch}: out of memory without remat')
                continue
            finally:
                del state, model
            if not math.isfinite(loss):
                raise AssertionError(f'{name}: loss {loss}')
            records[name] = rec
            log(f'zoo step {name} at {size}, batch {batch}, fp32{" remat" if remat else ""}: '
                f'{rec["ms_per_step"]:.1f} ms, device memory peak '
                f'{rec["peak_allocated_bytes"] / 2**30:.2f} GiB, loss {loss:.4f}')
            break
    launches = k2.launches
    if launches != steps:
        raise AssertionError(f'{steps} zoo steps, {launches} K2 launches')
    gc.collect()
    torch.cuda.empty_cache()
    return {'input_size': size, 'batch_size': batch, 'steps': steps, 'k2_launches': launches,
            'models': records}


def zoo_predict(tmp: str, main):
    """The predict path with configs/predict.yaml unchanged over ZOO_ENSEMBLE
    (random weights, seeds 0-2) on the main path's 32-frame pullback: every
    overlay and mask PNG at MAIN_OUT, K1 on frames x classes masks. Then each
    model alone over the pullback in one block: the chunk its memory probe
    chose, the predicted and the measured device memory peaks."""
    import gc

    import numpy as np
    import torch

    from octseg_torch.core.config import load_config
    from octseg_torch.infer.engine import InferenceEngine
    from octseg_torch.infer.predict import load_pullback_frames

    cfg = load_config('predict')
    classes = list(cfg.classes)
    models = make_ensemble(os.path.join(tmp, 'zoo_models'), ensemble=ZOO_ENSEMBLE)
    out = os.path.join(tmp, 'zoo_predict')
    overrides = [f'data_dir={main["dcm"]}', f'models_dir={models}', f'save_dir={out}',
                 f'output_size=[{MAIN_OUT},{MAIN_OUT}]', 'device=cuda']
    result, launches, shapes, _positive = predict_recorded(overrides, classes, out)
    secs = result['seconds']
    log(f'zoo predict: {result["frames"]} frames through '
        f'{[f"{n} {a}/{e}" for n, _c, a, e, _s in ZOO_ENSEMBLE]}, {launches} K1 launch(es) on '
        f'{shapes}, {result["frames"] / secs["total"]:.2f} frames/s end to end; seconds per '
        f'stage {json.dumps({k: round(v, 3) for k, v in secs.items()})}; chunks '
        f'{result["chunks"]}')
    frames = load_pullback_frames(main['dcm'])
    plans = {}
    for name, model_classes, arch, encoder, size in ZOO_ENSEMBLE:
        engine = InferenceEngine(models, model_classes, block_size=int(cfg.block_size),
                                 output_resize=str(cfg.get('output_resize', 'prob_bilinear')),
                                 device='cuda')
        list(engine.iter_pullback(frames, (MAIN_OUT, MAIN_OUT)))     # probe, plan
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        list(engine.iter_pullback(frames, (MAIN_OUT, MAIN_OUT)))
        rec = dict(next(iter(engine.chunk_plans.values()))._asdict(),
                   seconds=time.perf_counter() - t,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated())
        if rec['bytes_per_frame'] is None:
            raise AssertionError(f'{name}: the engine chose its chunk without a probe')
        plans[name] = dict(rec, model=f'{arch}/{encoder}', input_size=size)
        log(f'zoo predict, {name} {arch}/{encoder} at {size} alone, {len(frames)} frames: '
            f'chunk {rec["chunk"]}, {rec["bytes_per_frame"] / 2**20:.1f} MiB per frame fitted; '
            f'peak allocated predicted {rec["predicted_peak_bytes"] / 2**30:.2f} GiB, measured '
            f'{rec["peak_allocated_bytes"] / 2**30:.2f} GiB; {rec["seconds"]:.2f} s')
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return {'launches': launches, 'k1_shapes': shapes, 'frames': result['frames'],
            'seconds': secs, 'chunks': result['chunks'], 'models': plans,
            'frames_per_s': float(np.float64(result['frames']) / secs['total'])}


def tune_path(tmp: str):
    """``octseg_torch.tune.tune.main`` with configs/tune.yaml's search space
    unchanged (nine architectures, nine encoders, three optimizers, four
    learning rates, 512-896 px, batch 2), cut in depth: a synthetic fold of
    TUNE_SPLITS frames at TRAIN_FRAME_PX, TUNE_TRIALS trials of TUNE_EPOCHS
    epochs, HyperBand's first rung at TUNE_MIN_ITER, TUNE_N_RANDOM random
    trials before GP-EI. Every trial must end ``ok`` (a failed one's
    traceback is printed); K2 must launch once per step. Then the sweep
    again with one trial more: only that trial runs (resume)."""
    import csv
    import logging

    from octseg_torch.core.config import load_config
    from octseg_torch.data.synth import make_synth_fold
    from octseg_torch.ops.kernels import warp as k2
    from octseg_torch.tune.tune import RESULT_FIELDS
    from octseg_torch.tune.tune import main as tune

    fold = os.path.join(tmp, 'tune_fold')
    n_train, n_test = TUNE_SPLITS
    make_synth_fold(fold, n_train, n_test, size=TRAIN_FRAME_PX, seed=31)
    save_dir = os.path.join(tmp, 'tuning')
    batch = int(load_config('tune').batch_size)

    class Errors(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    errors = Errors()
    logging.getLogger('octseg_torch.tune.tune').addHandler(errors)

    def sweep(trials):
        k2.launches = 0
        t = time.perf_counter()
        best = tune(overrides=[f'data_dir={fold}', f'save_dir={save_dir}',
                               f'num_trials={trials}', f'epochs={TUNE_EPOCHS}',
                               f'hyperband_min_iter={TUNE_MIN_ITER}',
                               f'n_random={TUNE_N_RANDOM}'])
        wall = time.perf_counter() - t
        with open(os.path.join(save_dir, 'tuning_results.csv'), newline='') as f:
            reader = csv.DictReader(f)
            fields, rows = reader.fieldnames, list(reader)
        for message in errors.messages:
            log(message)
        if fields != RESULT_FIELDS or any(r['status'] != 'ok' for r in rows):
            raise AssertionError(f'tuning_results.csv: {fields}, {rows}')
        return best, rows, wall, k2.launches

    try:
        best, rows, wall, launches = sweep(TUNE_TRIALS)
        steps = sum(int(r['epochs_done']) for r in rows) * (n_train // batch)
        if [r['trial'] for r in rows] != [str(i) for i in range(TUNE_TRIALS)] \
                or launches != steps:
            raise AssertionError(f'{[r["trial"] for r in rows]}, {steps} steps, '
                                 f'{launches} K2 launches')
        _best, resumed, resume_wall, resume_launches = sweep(TUNE_TRIALS + 1)
        new = resumed[TUNE_TRIALS:]
        resume_steps = sum(int(r['epochs_done']) for r in new) * (n_train // batch)
        if resumed[:TUNE_TRIALS] != rows or [r['trial'] for r in new] != [str(TUNE_TRIALS)] \
                or resume_launches != resume_steps:
            raise AssertionError(f'resume ran {[r["trial"] for r in new]}, {resume_steps} '
                                 f'steps, {resume_launches} K2 launches')
    finally:
        logging.getLogger('octseg_torch.tune.tune').removeHandler(errors)
    trials = [{k: r[k] for k in ('trial', 'architecture', 'encoder', 'optimizer', 'lr',
                                 'input_size', 'val_f1', 'epochs_done', 'duration_s', 'status')}
              for r in resumed]
    for r in trials:
        log(f'tune trial {r["trial"]}: {r["architecture"]}/{r["encoder"]} {r["optimizer"]} '
            f'lr {r["lr"]} at {r["input_size"]}: val f1 {float(r["val_f1"]):.4f}, '
            f'{r["epochs_done"]} epoch(s), {r["duration_s"]} s, {r["status"]}')
    log(f'tune: {TUNE_TRIALS} trials in {wall:.1f} s ({steps} steps, {launches} K2 launches); '
        f'resume ran trial {TUNE_TRIALS} alone in {resume_wall:.1f} s ({resume_steps} steps, '
        f'{resume_launches} K2 launches); best {best}')
    return {'trials': trials, 'wall_s': wall, 'steps': steps, 'k2_launches': launches,
            'resume_wall_s': resume_wall, 'resume_steps': resume_steps,
            'resume_k2_launches': resume_launches, 'best': best}


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
        # one compiler per source, all started together: nvcc for the CUDA
        # kernels, g++ for the JPEG entropy decoder and the contour tracer
        with ThreadPoolExecutor(len(names) + 2) as pool:
            futures = [pool.submit(_build.load, name) for name in names]
            futures += [pool.submit(_build.load_host, name) for name in ('jpeg_entropy',
                                                                         'contours')]
            for fut in futures:
                fut.result()

    phases.run('build', build, ['postprocess', 'warp'])
    k1 = phases.run('K1 vs plain', check_k1, torch)
    k2 = phases.run('K2 vs plain', check_k2, torch)
    tmp = tempfile.mkdtemp(prefix='octseg_torch_smoke_')
    try:
        main = phases.run('predict path', main_path, tmp)
        jpeg = phases.run('JPEG decode', jpeg_decode)
        jpeg_predict = phases.run('JPEG pullback predict', jpeg_pullback, tmp, main)
        images = phases.run('image-directory predict', image_directory, tmp, main)
        memory = phases.run('block memory', block_memory, main)
        memory_bf16 = phases.run('block memory bf16', block_memory, main, True)
        bf16 = phases.run('bf16 predict', bf16_predict, tmp, main)
        served = phases.run('serve', serve_path, tmp, main, os.path.join(tmp, 'soft'))
        share = phases.run('routing GPU vs CPU', routing, tmp)
        logits = phases.run('logits GPU vs CPU', logits_gpu_vs_cpu, main)
        train = phases.run('training path', train_path, tmp)
        train_bf16 = phases.run('training path bf16', train_path, tmp, True)
        evaluated = phases.run('evaluate', evaluate_path, train)
        folds = phases.run('folds', folds_path, tmp)
        remat = phases.run('remat step', remat_step)
        b7_memory = phases.run('bf16 b7 step memory', b7_step_memory)
        step_gaps = phases.run('train step GPU vs CPU', train_step_gpu_vs_cpu)
        zoo_logits = phases.run('zoo logits GPU vs CPU', zoo_logits_gpu_vs_cpu, main)
        zoo = phases.run('zoo predict', zoo_predict, tmp, main)
        zoo_steps = phases.run('zoo train steps', zoo_train_steps)
        tuned = phases.run('tune', tune_path, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [{
        'name': 'fused_overlay_postprocess',
        'route': 'cuda',
        'source': 'octseg_torch/csrc/postprocess.cu',
        'replaces': 'octseg/ops/pallas/postprocess.py:149',
        'launches': main['launches'] + served['k1_launches'] + zoo['launches'],
        'launches_by_path': {'predict': main['launches'], 'serve client': served['k1_launches'],
                             'zoo predict': zoo['launches']},
        'shape': k1['shape'],
        'max_abs_err': k1['max_abs_err'],
        'ring_exact': k1['ring_exact'],
        'ms': k1['ms'],
        'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
        'library_ms': None,
        'ms_32x1000x1000': k1['ms_32'], 'plain_ms_32x1000x1000': k1['plain_ms_32'],
        'bound_ms_32x1000x1000': k1['bound_ms_32'],
        'ms_64x1000x1000': k1['ms_64'], 'plain_ms_64x1000x1000': k1['plain_ms_64'],
        'bound_ms_64x1000x1000': k1['bound_ms_64'],
    }, {
        'name': 'warp_pair',
        'route': 'cuda',
        'source': 'octseg_torch/csrc/warp.cu',
        'replaces': 'octseg/ops/pallas/resample.py:116',
        'launches': (train['launches']['k2'] + folds['k2_launches'] + zoo_steps['k2_launches']
                     + tuned['k2_launches'] + tuned['resume_k2_launches']),
        'launches_by_path': {'train': train['launches']['k2'], 'folds': folds['k2_launches'],
                             'zoo train steps': zoo_steps['k2_launches'],
                             'tune': tuned['k2_launches'] + tuned['resume_k2_launches']},
        'shape': k2['shape'],
        'max_abs_err': k2['max_abs_err'],
        'masks_exact': k2['masks_exact'],
        'ms': k2['ms'],
        'ms_cold_l2': k2['ms_cold_l2'],
        'plain_ms': k2['plain_ms'],
        'bound_ms': k2['bound_ms'], 'bound_by': k2['bound_by'],
        'library_ms': k2['library_ms'],
        'library_ms_cold_l2': k2['library_ms_cold_l2'],
        # the tune and zoo train steps' shape, which takes the general path
        **{k: v for k, v in k2.items() if k.endswith('_2x896x896x3x1')},
    }]
    print(json.dumps({'kernels': kernels,
                      'predict_path': {k: main[k] for k in (
                          'frames', 'seconds', 'chunks', 'k1_shapes', 'positive_share',
                          'peak_allocated_bytes')},
                      'jpeg_decode': jpeg,
                      'jpeg_pullback_predict': jpeg_predict,
                      'image_directory_predict': images,
                      'block_memory': memory,
                      'block_memory_bf16': memory_bf16,
                      'bf16_predict': bf16,
                      'serve': served,
                      'evaluate': evaluated,
                      'folds': folds,
                      'routing_near_half_share': share,
                      'logits_gpu_vs_cpu': logits,
                      'training_path': train,
                      'training_path_bf16': train_bf16,
                      'remat_step': remat,
                      'bf16_b7_step_memory': b7_memory,
                      'train_step_gpu_vs_cpu': step_gaps,
                      'zoo_logits_gpu_vs_cpu': zoo_logits,
                      'zoo_predict': {k: zoo[k] for k in ('frames', 'seconds', 'chunks',
                                                          'k1_shapes', 'frames_per_s',
                                                          'models')},
                      'zoo_train_steps': zoo_steps,
                      'tune': tuned}), flush=True)
    log(f'total {time.perf_counter() - phases.t0:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
