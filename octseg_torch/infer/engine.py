"""Hybrid per-feature ensemble inference on one GPU.

The port of octseg/infer/engine.py: the pullback path (``iter_pullback``,
``segment_pullback``) and the image path (``segment``, ``run_model``). Each
routed model runs once per frame block, even when it serves two classes. On
the pullback path a block goes uint8 frames -> BGR float -> bilinear resize
to the model size on the device (octseg's ``device_preprocess=True``
program); on the image path the host has already made uint8 BGR frames at
the model size (``data/utils.preprocessing_img``: Pillow's resize to the
output size, then cv2's INTER_LINEAR to the input size) and the device only
makes them float (``device_preprocess=False``). Then forward -> sigmoid ->
output resize -> threshold -> bitpack, and the host expands the bits into
the routed channels of the (N, H, W, 4) masks.

Kept from the reference: MODELS_META routing; the two ``output_resize``
modes; the reference predict() quirk (BGR floats 0..255, ImageNet mean/std
only when the manifest says ``normalize: true``); the mono upload of
grayscale pullbacks; a one-block-deep pipeline in ``iter_pullback``, here
with pinned host buffers, ``non_blocking`` copies and CUDA events: block
k+1's upload and forward are queued before block k's bits are expanded on
the host.

The block is ``block_size`` floored to a power of two, as the reference
floors it on one device. Each model runs the block in chunks (octseg's
``_block_for`` and chunked dispatch, on one card): the largest chunk, the
block and then the powers of two below it, whose peak device memory fits.
The peak is predicted from a measured probe, not from a caught
out-of-memory error: the model's forward (the variant that will run, at
its frame shape) runs on zeros at two small chunk sizes, a line through
their peak allocations gives fixed bytes plus bytes per frame, and the
chunk's predicted peak must fit CHUNK_MARGIN of the device memory still
free (``torch.cuda.mem_get_info`` plus the allocator's cached, unallocated
bytes) less what the block's pipeline keeps resident beside it. Every
model of the plan is loaded before the probe, so its parameters are
already allocated and outside that free memory. The render's postprocess
buffers (fill and ring, 12 B per mask pixel) are not counted:
they are allocated after the block's forwards have returned their
activations to the allocator's cache, and reuse it (chip_smoke.py's block
memory phase checks this). On the CPU there is no probe: the chunk is the
block.

``bf16=True`` builds every model with bfloat16 compute (octseg's
``compute_dtype``: float32 parameters, bfloat16 convolutions, float32
BatchNorm and logits; models/common.py); the probe measures its smaller
activations like any others. Not ported: the device mesh, int8 and AOT
exports (ROADMAP.md, "Opt-in, last").

fp32 convolutions run with TF32 off (``torch.backends.cudnn.flags(...,
allow_tf32=False)``) and so do matmuls (``torch.backends.cuda.matmul
.allow_tf32 = False``): the port is held to the JAX package's fp32 numbers.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from octseg_torch import resolve_device
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.data.image import PilImage
from octseg_torch.data.utils import preprocessing_img
from octseg_torch.models import create_model
from octseg_torch.models.convert import variables_to_state_dict
from octseg_torch.ops.bitpack import pack_mask_bits, unpack_mask_bits, unpack_route_into
from octseg_torch.ops.normalize import normalize_imagenet, sigmoid_threshold
from octseg_torch.ops.resize import resize_bilinear_nchw, resize_nearest_nchw
from octseg_torch.train.checkpoint import load_weights

log = logging.getLogger(__name__)

# Routing table: class -> (model dir, output channel) (reference
# src/predict.py:23-28)
MODELS_META = {
    'Lumen': {'model_dir': 'LM', 'index': 0},
    'Lipid core': {'model_dir': 'FC_LC', 'index': 0},
    'Fibrous cap': {'model_dir': 'FC_LC', 'index': 1},
    'Vasa vasorum': {'model_dir': 'VV', 'index': 0},
}


# the share of the free device memory a chunk's predicted allocation may
# take: the caching allocator reserves up to about 1.5x what is allocated
# (split and rounded segments). Measured on an H100 with each ensemble model
# at 32 and 128 frames, allowed to reserve only the predicted peak / 0.8,
# most runs ran out of memory, and at / 0.7 one did (PERF.md, section 6);
# chip_smoke.py checks that every run fits at / CHUNK_MARGIN. Above the
# prediction, a forward also takes spare memory when there is some (a
# 32-frame UNet++/resnet101 block peaks at about 2.7x its prediction on an
# idle card) and does without it under such a cap.
CHUNK_MARGIN = 0.6
PROBE_CHUNKS = (2, 4)


class ChunkPlan(NamedTuple):
    """One model's chunk for one block shape. On the GPU also the fitted
    bytes per frame, the predicted peak of device memory allocated while a
    chunk runs (resident bytes included) and the budget a chunk's own
    allocations had to fit; None on the CPU."""
    chunk: int
    bytes_per_frame: Optional[float] = None
    predicted_peak_bytes: Optional[int] = None
    budget_bytes: Optional[int] = None


def choose_chunk(block: int, probes: Sequence[Tuple[int, int]], budget: int
                 ) -> Tuple[int, float, float]:
    """(chunk, bytes per frame, predicted bytes): the largest chunk, ``block``
    and then the powers of two below it, whose allocation predicted by the
    line through ``probes`` ((frames, peak bytes), two of them) fits
    ``budget``. Raises RuntimeError when even a chunk of 1 does not."""
    (c1, b1), (c2, b2) = probes
    per_frame = max((b2 - b1) / (c2 - c1), 0.0)
    fixed = b1 - per_frame * c1
    chunk = block
    while fixed + per_frame * chunk > budget:
        if chunk == 1:
            raise RuntimeError(
                f'one frame needs {(fixed + per_frame) / 2**30:.2f} GiB of device memory '
                f'and {budget / 2**30:.2f} GiB are free for it: unload other models or use '
                f'a larger card')
        chunk = 1 << ((chunk - 1).bit_length() - 1)
    return chunk, per_frame, fixed + per_frame * chunk


@contextlib.contextmanager
def fp32_exact():
    """Full-fp32 convolutions and matmuls (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def load_model_bundle(model_dir: str, device, dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.nn.Module, dict]:
    """(model in eval mode on ``device``, computing in ``dtype``, manifest)
    from a model dir (config.json + weights.ckpt in the flax msgpack
    layout)."""
    with open(os.path.join(model_dir, 'config.json')) as f:
        model_cfg = json.load(f)
    arch, encoder = model_cfg['architecture'], model_cfg['encoder']
    model = create_model(arch, encoder, classes=len(model_cfg['classes']), dtype=dtype)
    sd = variables_to_state_dict(
        load_weights(os.path.join(model_dir, 'weights.ckpt')), arch, encoder)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model.eval().to(device), model_cfg


class InferenceEngine:
    """Hybrid per-feature ensemble predictor on one device."""

    def __init__(self, models_dir: str, classes: Sequence[str],
                 block_size: int = 128, output_resize: str = 'prob_bilinear',
                 device=None, bf16: bool = False):
        # output_resize: 'prob_bilinear' (default) resizes the sigmoid
        # probabilities bilinearly, then thresholds at 0.5; 'nearest' is the
        # reference's contract (threshold, then cv2 NEAREST resize)
        if output_resize not in ('prob_bilinear', 'nearest'):
            raise ValueError(f'unknown output_resize mode: {output_resize!r}')
        if block_size < 1:
            raise ValueError(f'block_size must be >= 1, got {block_size}')
        self.output_resize = output_resize
        self.classes = list(classes)
        self.models_dir = models_dir
        # the reference's per-device quota is a power of two; one device here
        self.block_size = 1 << (int(block_size).bit_length() - 1)
        self.device = resolve_device(device)
        self.compute_dtype = torch.bfloat16 if bf16 else torch.float32
        self._bundles: Dict[str, tuple] = {}
        # (model dir, forward variant, block frame shape, output size) -> ChunkPlan
        self.chunk_plans: Dict[tuple, ChunkPlan] = {}

    def _bundle(self, model_dir_name: str):
        if model_dir_name not in self._bundles:
            path = os.path.join(self.models_dir, model_dir_name)
            self._bundles[model_dir_name] = load_model_bundle(path, self.device,
                                                              self.compute_dtype)
            log.info('Loaded model %s', path)
        return self._bundles[model_dir_name]

    def _forward_fn(self, model_dir_name: str, out_h: int, out_w: int,
                    device_preprocess: bool = True):
        """Callable: frames on the device -> bitpacked masks on the device,
        (B, out_h, ceil(out_w / 8), C) uint8 with C the model's classes.
        ``device_preprocess`` (the pullback variant): uint8 (B, H, W, 1 or
        3) RGB frames at native size, made BGR and resized on the device;
        otherwise (the image variant) uint8 (B, S, S, 3) BGR frames at the
        model's input size S (int32 from I;16 images), made float on the
        device."""
        model, model_cfg = self._bundle(model_dir_name)
        input_size = int(model_cfg['input_size'])
        # octseg-trained manifests say normalize=true; an absent key is the
        # reference predict() quirk: raw BGR 0..255 floats, no mean/std
        normalize = bool(model_cfg.get('normalize', False))
        output_resize = self.output_resize

        def forward(imgs: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode(), fp32_exact():
                if device_preprocess:
                    # RGB -> BGR (an identity on one channel), then resize; a
                    # mono frame broadcasts to 3 channels after the resize
                    x = imgs.flip(-1).float().permute(0, 3, 1, 2)
                    x = resize_bilinear_nchw(x, (input_size, input_size))
                    if x.shape[1] == 1:
                        x = x.expand(-1, 3, -1, -1)
                else:
                    x = imgs.float().permute(0, 3, 1, 2)
                if normalize:
                    x = normalize_imagenet(x, channel_dim=1)
                logits = model(x.contiguous())
                if output_resize == 'prob_bilinear':
                    probs = resize_bilinear_nchw(torch.sigmoid(logits), (out_h, out_w))
                    masks = probs > 0.5
                else:
                    masks = resize_nearest_nchw(sigmoid_threshold(logits), (out_h, out_w))
                return pack_mask_bits(masks.permute(0, 2, 3, 1))

        return forward

    def _memory_probe(self, forward, frame_shape: Sequence[int]
                      ) -> Optional[Tuple[List[Tuple[int, int]], int, int]]:
        """On the GPU: ([(frames, peak bytes)] of ``forward`` on uint8 zeros
        at PROBE_CHUNKS frames, peaks counted above the allocation before
        each run; the bytes allocated now; the bytes that can still be
        allocated). None on the CPU. Resets the device's peak-memory
        counter."""
        if self.device.type != 'cuda':
            return None
        samples = []
        for c in PROBE_CHUNKS:
            x = torch.zeros((c, *frame_shape[1:]), dtype=torch.uint8, device=self.device)
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            forward(x)
            torch.cuda.synchronize(self.device)
            samples.append((c, torch.cuda.max_memory_allocated(self.device) - before))
            del x
        allocated = torch.cuda.memory_allocated(self.device)
        free, _total = torch.cuda.mem_get_info(self.device)
        return samples, allocated, free + torch.cuda.memory_reserved(self.device) - allocated

    def _chunk_for(self, name: str, variant: str, forward, frame_shape: Sequence[int],
                   out_hw: Tuple[int, int], resident: int) -> int:
        """The chunk ``name`` runs a block of ``frame_shape`` frames in,
        decided once per (model, forward variant, block frame shape, output
        size): the pullback variant (frames at native size, resized on the
        device) and the image variant (frames at the input size) may share a
        frame shape and need different memory, so a plan of one is never
        reused for the other. ``resident``: device bytes the caller holds
        beside a chunk that are not allocated yet."""
        key = (name, variant, tuple(frame_shape), tuple(out_hw))
        if key not in self.chunk_plans:
            probe = self._memory_probe(forward, frame_shape)
            if probe is None:
                plan = ChunkPlan(int(frame_shape[0]))
                log.info('%s: chunk %d (no probe on %s)', name, plan.chunk, self.device)
            else:
                samples, allocated, available = probe
                budget = int(CHUNK_MARGIN * (available - resident))
                chunk, per_frame, predicted = choose_chunk(int(frame_shape[0]), samples, budget)
                plan = ChunkPlan(chunk, per_frame, int(allocated + resident + predicted), budget)
                log.info('%s: chunk %d of %d frames, %.1f MiB per frame fitted, predicted '
                         'peak %.2f GiB allocated, budget %.2f GiB', name, chunk,
                         frame_shape[0], per_frame / 2**20, plan.predicted_peak_bytes / 2**30,
                         budget / 2**30)
            self.chunk_plans[key] = plan
        return self.chunk_plans[key].chunk

    @staticmethod
    def _as_mono_if_gray(frames: np.ndarray) -> np.ndarray:
        """Grayscale-replicated pullbacks drop to one channel (3x less
        upload); the forward broadcasts after the resize. A strided sample
        rejects color pullbacks before the full scan."""
        if frames.shape[-1] != 3:
            return frames
        s = frames[:: max(1, frames.shape[0] // 16), ::37, ::41]
        if ((s[..., 0] == s[..., 1]).all()
                and (s[..., 1] == s[..., 2]).all()
                and (frames[..., 0] == frames[..., 1]).all()
                and (frames[..., 1] == frames[..., 2]).all()):
            return np.ascontiguousarray(frames[..., :1])
        return frames

    def _ensemble_plan(self) -> Dict[str, list]:
        """{model_dir: [(class, model channel, mask channel), ...]}."""
        plan: Dict[str, list] = {}
        for class_name in self.classes:
            meta = MODELS_META[class_name]
            plan.setdefault(meta['model_dir'], []).append(
                (class_name, meta['index'], CLASS_IDS[class_name] - 1))
        return plan

    def iter_pullback(self, frames: np.ndarray, output_size: Sequence[int]
                      ) -> Iterator[Tuple[int, np.ndarray]]:
        """Streaming pullback inference: yields ``(start, masks_block)``, one
        engine block at a time in frame order; masks_block is
        (<= block_size, out_h, out_w, 4) float32 {0,1}.

        frames: (N, H, W, 3) RGB or (N, H, W, 1) mono uint8 on the host.
        Host memory stays bounded by two frame blocks and two mask blocks."""
        if not isinstance(frames, np.ndarray):
            raise TypeError('iter_pullback streams host-resident numpy pullbacks')
        out_h, out_w = int(output_size[0]), int(output_size[1])
        n = int(frames.shape[0])
        if n == 0:
            return
        plan = self._ensemble_plan()
        frames = self._as_mono_if_gray(frames)
        # every model is loaded before any is probed
        forwards = {name: self._forward_fn(name, out_h, out_w) for name in plan}
        eb = min(self.block_size, n)
        cuda = self.device.type == 'cuda'
        # beside a chunk: two blocks' device copies and two blocks' packed
        # outputs of every model (pipeline depth 1)
        packed_bytes = sum(eb * out_h * ((out_w + 7) // 8) * len(self._bundle(name)[1]['classes'])
                           for name in plan)
        resident = 2 * (eb * int(np.prod(frames.shape[1:])) + packed_bytes)
        block_shape = (eb, *frames.shape[1:])
        runs = {name: (fwd, self._chunk_for(name, 'pullback', fwd, block_shape, (out_h, out_w),
                                            resident))
                for name, fwd in forwards.items()}
        # two pinned upload slots: block k fills slot k % 2 while the copy
        # of block k - 1 from the other slot may still be in flight
        slots = [torch.empty((eb, *frames.shape[1:]), dtype=torch.uint8,
                             pin_memory=cuda) for _ in range(2)]

        def dispatch(k: int, start: int):
            take = min(eb, n - start)
            host = slots[k % 2][:take]
            host.numpy()[...] = frames[start:start + take]
            dev = host.to(self.device, non_blocking=True)
            outs = {}
            for name, (fwd, chunk) in runs.items():
                parts = [fwd(dev[s:s + chunk]) for s in range(0, take, chunk)]
                packed = parts[0] if len(parts) == 1 else torch.cat(parts)
                outs[name] = packed.to('cpu', non_blocking=True) if cuda else packed
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            return start, take, outs, event

        def drain(pending) -> Tuple[int, np.ndarray]:
            start, take, outs, event = pending
            if event is not None:
                event.synchronize()
            block_masks = np.zeros((take, out_h, out_w, 4), np.float32)
            for name, class_routes in plan.items():
                unpack_route_into(outs[name].numpy(), block_masks,
                                  [(ch, mask_ch) for _cls, ch, mask_ch in class_routes])
            return start, block_masks

        pending = None
        for k, start in enumerate(range(0, n, eb)):
            # pipeline depth 1: block k is queued on the device before block
            # k - 1's bits are expanded on the host
            cur = dispatch(k, start)
            if pending is not None:
                yield drain(pending)
            pending = cur
        yield drain(pending)

    def segment_pullback(self, frames: np.ndarray, output_size: Sequence[int]
                         ) -> np.ndarray:
        """(N, H, W, 1 or 3) uint8 frames -> (N, out_h, out_w, 4) float32
        {0,1} ensemble masks for the whole pullback."""
        out_h, out_w = int(output_size[0]), int(output_size[1])
        result = np.zeros((frames.shape[0], out_h, out_w, 4), np.float32)
        for start, block in self.iter_pullback(frames, output_size):
            result[start:start + block.shape[0]] = block
        return result

    def run_model(self, model_dir_name: str, images: Sequence[PilImage],
                  output_size: Sequence[int]) -> np.ndarray:
        """All images through one model (octseg's ``run_model``): (N, out_h,
        out_w, C) uint8 {0,1} masks, C the model's classes. Blocks of
        ``block_size`` images are preprocessed on the host (a thread pool:
        numpy releases the interpreter lock) and run in chunks chosen by the
        probe of the image variant."""
        out_h, out_w = int(output_size[0]), int(output_size[1])
        fwd = self._forward_fn(model_dir_name, out_h, out_w, device_preprocess=False)
        model_cfg = self._bundle(model_dir_name)[1]
        size, n_cls = int(model_cfg['input_size']), len(model_cfg['classes'])
        n = len(images)
        result = np.zeros((n, out_h, out_w, n_cls), np.uint8)
        if n == 0:
            return result
        eb = min(self.block_size, n)
        # beside a chunk: the block's frames and its packed masks
        resident = eb * size * size * 3 + eb * out_h * ((out_w + 7) // 8) * n_cls
        chunk = self._chunk_for(model_dir_name, 'images', fwd, (eb, size, size, 3),
                                (out_h, out_w), resident)
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for start in range(0, n, eb):
                frames = np.stack(list(pool.map(lambda img: preprocessing_img(img, size),
                                                images[start:start + eb])))
                if frames.dtype == np.uint16:   # I;16 images; made float on the device
                    frames = frames.astype(np.int32)
                dev = torch.from_numpy(frames).to(self.device)
                packed = torch.cat([fwd(dev[s:s + chunk]) for s in range(0, len(frames), chunk)])
                result[start:start + len(frames)] = unpack_mask_bits(packed.cpu().numpy(), out_w)
        return result

    def segment(self, images: Sequence[PilImage], masks: List[np.ndarray],
                output_size: Sequence[int]) -> List[np.ndarray]:
        """Fill the routed channels of the (out_h, out_w, 4) ``masks``, one
        per image, in place (octseg's ``segment``); each model runs once even
        when it serves two classes. Every model is loaded before any is
        probed. Returns ``masks``."""
        plan = self._ensemble_plan()
        for name in plan:
            self._bundle(name)
        for name, class_routes in plan.items():
            pred = self.run_model(name, images, output_size)
            for _cls, ch, mask_ch in class_routes:
                for i, mask in enumerate(masks):
                    mask[:, :, mask_ch] = pred[i, :, :, ch]
        return masks
