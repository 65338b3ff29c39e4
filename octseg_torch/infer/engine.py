"""Hybrid per-feature ensemble inference on one GPU.

The port of octseg/infer/engine.py's pullback path. Each routed model runs
once per frame block, even when it serves two classes; on the device a block
goes uint8 frames -> BGR float -> bilinear resize to the model size ->
forward -> sigmoid -> output resize -> threshold -> bitpack, and the host
expands the bits into the routed channels of the (N, H, W, 4) mask block.

Kept from the reference: MODELS_META routing; the two ``output_resize``
modes; the reference predict() quirk (BGR floats 0..255, ImageNet mean/std
only when the manifest says ``normalize: true``); the mono upload of
grayscale pullbacks; a one-block-deep pipeline in ``iter_pullback``, here
with pinned host buffers, ``non_blocking`` copies and CUDA events: block
k+1's upload and forward are queued before block k's bits are expanded on
the host.

Not ported: bf16 and memory-driven block sizing (ROADMAP.md, "Memory-driven
block sizing, then bf16"); the device mesh, int8 and AOT exports ("Opt-in,
last"). The block is ``block_size`` floored to a power of two, as the
reference floors it on one device.

fp32 convolutions run with TF32 off (``torch.backends.cudnn.flags(...,
allow_tf32=False)``) and so do matmuls (``torch.backends.cuda.matmul
.allow_tf32 = False``): the port is held to the JAX package's fp32 numbers.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from octseg_torch import resolve_device
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.models import create_model
from octseg_torch.models.convert import variables_to_state_dict
from octseg_torch.ops.bitpack import pack_mask_bits, unpack_route_into
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


def load_model_bundle(model_dir: str, device) -> Tuple[torch.nn.Module, dict]:
    """(model in eval mode on ``device``, manifest) from a model dir
    (config.json + weights.ckpt in the flax msgpack layout)."""
    with open(os.path.join(model_dir, 'config.json')) as f:
        model_cfg = json.load(f)
    arch, encoder = model_cfg['architecture'], model_cfg['encoder']
    model = create_model(arch, encoder, classes=len(model_cfg['classes']))
    sd = variables_to_state_dict(
        load_weights(os.path.join(model_dir, 'weights.ckpt')), arch, encoder)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model.eval().to(device), model_cfg


class InferenceEngine:
    """Hybrid per-feature ensemble predictor on one device."""

    def __init__(self, models_dir: str, classes: Sequence[str],
                 block_size: int = 128, output_resize: str = 'prob_bilinear',
                 device=None):
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
        self._bundles: Dict[str, tuple] = {}

    def _bundle(self, model_dir_name: str):
        if model_dir_name not in self._bundles:
            path = os.path.join(self.models_dir, model_dir_name)
            self._bundles[model_dir_name] = load_model_bundle(path, self.device)
            log.info('Loaded model %s', path)
        return self._bundles[model_dir_name]

    def _forward_fn(self, model_dir_name: str, out_h: int, out_w: int):
        """Callable: uint8 (B, H, W, 1 or 3) RGB frames at native size on
        the device -> bitpacked masks on the device, (B, out_h,
        ceil(out_w / 8), C) uint8 with C the model's classes. Preprocessing
        runs on the device (octseg's ``device_preprocess=True`` program)."""
        model, model_cfg = self._bundle(model_dir_name)
        input_size = int(model_cfg['input_size'])
        # octseg-trained manifests say normalize=true; an absent key is the
        # reference predict() quirk: raw BGR 0..255 floats, no mean/std
        normalize = bool(model_cfg.get('normalize', False))
        output_resize = self.output_resize

        def forward(imgs: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode(), fp32_exact():
                # RGB -> BGR (an identity on one channel), then resize; a
                # mono frame broadcasts to 3 channels after the resize
                x = imgs.flip(-1).float().permute(0, 3, 1, 2)
                x = resize_bilinear_nchw(x, (input_size, input_size))
                if x.shape[1] == 1:
                    x = x.expand(-1, 3, -1, -1)
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
        runs = {name: self._forward_fn(name, out_h, out_w) for name in plan}
        eb = min(self.block_size, n)
        cuda = self.device.type == 'cuda'
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
            for name, fwd in runs.items():
                packed = fwd(dev)
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
