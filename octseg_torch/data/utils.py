"""Overlay writer (the port of save_results and its helpers in
octseg/data/utils.py).

``save_results`` writes ``{name}_overlay.png`` and ``{name}_mask.png`` per
frame, as the reference does: the fill and ring of every class come from the
fused overlay postprocess (the CUDA kernel for masks on the GPU, its plain
torch chain on the CPU); compositing is Pillow's integer paste and the PNGs
are written without PIL (data/image.py). The alpha masks keep the
reference's uint8 wraparound: fill alpha = uint8(fill * 64 * 0.85 * 255),
ring alpha = uint8(ring * 255 * 0.85 * 255).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

import numpy as np
import torch

import octseg_torch
from octseg_torch.core.registry import CLASS_COLORS_RGB, CLASS_IDS
from octseg_torch.data.image import paste_solid, write_png
from octseg_torch.ops.kernels.postprocess import fused_overlay_postprocess
# the kernel's plain version, counterpart of octseg.data.utils._postprocess_chain
from octseg_torch.ops.kernels.postprocess import postprocess_chain as _postprocess_chain  # noqa: F401


def postprocess_masks(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fill, ring) for stacked binary masks (M, H, W) float32: the CUDA
    kernel for a CUDA tensor, the plain chain for a CPU tensor."""
    return fused_overlay_postprocess(m)


def _wrap_uint8(x: np.ndarray) -> np.ndarray:
    """C-cast float -> uint8 conversion (modular wrap), as numpy astype."""
    return x.astype(np.int64).astype(np.uint8)


def _write_frame(img: np.ndarray, mask: np.ndarray, fill: np.ndarray,
                 ring: np.ndarray, classes: Sequence[str], path_base: str) -> None:
    img = img.copy()
    color_mask = np.full(img.shape, 128, np.uint8)
    for j, class_name in enumerate(classes):
        color = CLASS_COLORS_RGB[class_name]
        # float32 products in the reference's order, then the uint8 wrap
        paste_solid(img, color, _wrap_uint8(fill[j] * 64.0 * 0.85 * 255.0))
        paste_solid(img, color, _wrap_uint8(ring[j] * 255.0 * 0.85 * 255.0))
        m255 = mask[:, :, CLASS_IDS[class_name] - 1] * 255
        paste_solid(color_mask, color, np.clip(m255, 0, 255).astype(np.uint8))
    write_png(f'{path_base}_mask.png', color_mask)
    write_png(f'{path_base}_overlay.png', img)


def save_results(images: Sequence[np.ndarray], masks: Sequence[np.ndarray],
                 images_name: Sequence[str], classes: Sequence[str],
                 save_dir: str, device=None) -> None:
    """Write the reference's PNG pair per frame.

    images: uint8 (H, W, 3) RGB frames at output size; masks: (H, W, 4)
    {0,1} per frame; the postprocess runs on ``device`` (default: the GPU,
    see ``octseg_torch.resolve_device``). Frames are
    composited and encoded on a thread pool (zlib and numpy release the
    interpreter lock)."""
    device = octseg_torch.resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    if len(images) == 0:
        return
    stack = np.asarray(masks)
    sel = stack[..., [CLASS_IDS[c] - 1 for c in classes]]  # (N, H, W, K)
    n, h, w, k = sel.shape
    m = torch.from_numpy(np.ascontiguousarray(sel.transpose(0, 3, 1, 2), np.float32))
    fill, ring = postprocess_masks(m.reshape(n * k, h, w).to(device))
    fill = fill.cpu().numpy().reshape(n, k, h, w)
    ring = ring.cpu().numpy().reshape(n, k, h, w)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        futures = [pool.submit(_write_frame, images[i], stack[i], fill[i], ring[i],
                               list(classes), os.path.join(save_dir, images_name[i]))
                   for i in range(n)]
        for fut in futures:
            fut.result()
