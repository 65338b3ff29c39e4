"""Inference input and output on the host (the port of octseg/data/utils.py:
``get_file_list``, ``get_dir_list``, ``preprocessing_img``,
``data_processing`` and ``save_results``).

``data_processing`` reads a directory of PNG and JPEG files as octseg does
through ``PIL.Image.open(p).resize(...)`` (data/image.py: ``open_image`` and
``pil_resize``, Pillow's default filter per mode) and ``preprocessing_img``
makes the model input as octseg does with ``np.array(img)``,
``cv2.cvtColor(RGB2BGR)`` and ``cv2.resize`` (``resize_linear_u8``).

``save_results`` writes ``{name}_overlay.png`` and ``{name}_mask.png`` per
frame, as the reference does: the fill and ring of every class come from the
fused overlay postprocess (the CUDA kernel for masks on the GPU, its plain
torch chain on the CPU); compositing is Pillow's integer paste and the PNGs
are written without PIL (data/image.py). The alpha masks keep the
reference's uint8 wraparound: fill alpha = uint8(fill * 64 * 0.85 * 255),
ring alpha = uint8(ring * 255 * 0.85 * 255).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import octseg_torch
from octseg_torch.core.registry import CLASS_COLORS_RGB, CLASS_IDS
from octseg_torch.data.image import (PilImage, open_image, paste_solid, pil_resize,
                                     resize_linear_u8, write_png)
from octseg_torch.ops.kernels.postprocess import fused_overlay_postprocess
# the kernel's plain version, counterpart of octseg.data.utils._postprocess_chain
from octseg_torch.ops.kernels.postprocess import postprocess_chain as _postprocess_chain  # noqa: F401


def get_file_list(src_dirs: Union[List[str], str], ext_list: Union[List[str], str],
                  filename_template: str = '') -> List[str]:
    """Files under ``src_dirs`` (walked) whose lower-case suffix is in
    ``ext_list`` and whose name contains ``filename_template``, sorted."""
    all_files = []
    src_dirs = [src_dirs] if isinstance(src_dirs, str) else src_dirs
    ext_list = [ext_list] if isinstance(ext_list, str) else ext_list
    for src_dir in src_dirs:
        for root, _dirs, files in os.walk(src_dir):
            for file in files:
                if Path(file).suffix.lower() in ext_list and filename_template in file:
                    all_files.append(os.path.join(root, file))
    all_files.sort()
    return all_files


def get_dir_list(data_dir: str, include_dirs: Optional[List[str]] = None,
                 exclude_dirs: Optional[List[str]] = None) -> List[str]:
    """The subdirectories of ``data_dir`` (with a trailing slash), filtered
    by name, sorted."""
    dir_list = []
    for series_dir in glob(data_dir + '/*/'):
        name = Path(series_dir).name
        if include_dirs and name not in include_dirs:
            logging.info('%s not in include_dirs — skipping', name)
            continue
        if exclude_dirs and name in exclude_dirs:
            logging.info('%s listed in exclude_dirs — skipping', name)
            continue
        dir_list.append(series_dir)
    dir_list.sort()
    return dir_list


def preprocessing_img(img: PilImage, input_size: int) -> np.ndarray:
    """The model input of one image: ``np.array(img)`` (palette indices for
    P), ``cv2.cvtColor(RGB2BGR)`` (three channels reversed, alpha dropped,
    one channel replicated), ``cv2.resize`` INTER_LINEAR to input_size;
    (input_size, input_size, 3) uint8."""
    px = img.pixels
    bgr = np.repeat(px[..., None], 3, axis=-1) if px.ndim == 2 else px[..., 2::-1]
    return resize_linear_u8(np.ascontiguousarray(bgr), (input_size, input_size))


def data_processing(data_path: str, save_dir: str, output_size: Sequence[int]
                    ) -> Tuple[List[PilImage], List[np.ndarray], List[str]]:
    """(images resized to ``output_size`` = [height, width], float64 zero
    masks (height, width, 4), names): every ``*.[pj][np][ge]*`` file of the
    directory ``data_path`` in sorted order, or the one file it names. The
    name is the file name up to its first dot. Creates ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    if os.path.isfile(data_path):
        images_path = [data_path]
    else:
        images_path = sorted(glob(f'{data_path}/*.[pj][np][ge]*'))
    images, masks, image_names = [], [], []
    for img_path in images_path:
        images.append(pil_resize(open_image(img_path), (output_size[1], output_size[0])))
        masks.append(np.zeros((output_size[0], output_size[1], 4)))
        image_names.append(os.path.basename(img_path).split('.')[0])
    return images, masks, image_names


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
