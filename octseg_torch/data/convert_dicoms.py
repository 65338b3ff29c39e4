"""DICOM -> per-slice PNGs (the port of octseg/data/convert_dicoms.py,
image output).

Per slice: min-max normalisation to uint8 (``normalize_slice``), the
channel swap octseg's cv2 pipeline makes, optionally the grayscale aid
(``convert_to_grayscale``: cv2's RGB -> gray of the swapped channels, clip,
``equalizeHist``), then an aspect-preserving INTER_LINEAR resize to the
output height (the width truncated, as imutils does), written as
``<save_dir>/<study>/<series>/<study>_<series>_<NNN>.png`` with the pixels
cv2.imwrite stores. Studies fan out over a thread pool. Video output raises
NotImplementedError (ROADMAP.md, "Video output and reading").

Paths in the config resolve against the working directory.

Config: configs/convert_dicoms.yaml. Usage:
python -m octseg_torch.data.convert_dicoms [key=value ...]
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from octseg_torch.core.config import Config, entry_point
from octseg_torch.data import dicom
from octseg_torch.data.image import normalize_slice, resize_linear_u8
from octseg_torch.data.io import imwrite
from octseg_torch.data.utils import (convert_to_grayscale, get_dir_list, get_file_list,
                                     get_series_name, get_study_name)

log = logging.getLogger(__name__)

VIDEO_ITEM = 'ROADMAP.md, "Video output and reading"'


def video_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f'{what}: octseg_torch writes image output only; video output '
                               f'is not ported yet ({VIDEO_ITEM})')


def resize_keep_aspect(img: np.ndarray, height: int) -> np.ndarray:
    """Aspect-preserving INTER_LINEAR resize to ``height`` rows, the width
    int(w * height / h)."""
    h, w = img.shape[:2]
    if h == height:
        return img
    width = int(w * (height / float(h)))
    return resize_linear_u8(img, (width, height))


def convert_single_study(data_dir: str, output_type: str, output_size: Tuple[int, int],
                         to_gray: bool, fps: int, save_dir: str) -> None:
    """Every ``IMG*`` DICOM under ``data_dir`` to PNG slices."""
    if output_type == 'video':
        raise video_not_ported('convert_dicoms output_type=video')
    if output_type != 'image':
        raise ValueError(f'Unknown output_type value: {output_type}')
    for dcm_path in get_file_list(src_dirs=data_dir, ext_list='', filename_template='IMG'):
        frames = dicom.dcmread(dcm_path).pixel_array
        if frames.ndim == 3:
            frames = frames[..., None].repeat(3, axis=-1)
        study_name = get_study_name(dcm_path)
        series_name = get_series_name(dcm_path)
        save_dir_img = os.path.join(save_dir, study_name, series_name)
        os.makedirs(save_dir_img, exist_ok=True)
        for idx in range(frames.shape[0]):
            # octseg's cvtColor(BGR2RGB) of the DICOM's RGB frame
            img = np.ascontiguousarray(normalize_slice(frames[idx])[..., ::-1])
            if to_gray:
                img = convert_to_grayscale(img, min_limit=40, max_limit=220)
            if img.shape[:2] != tuple(output_size):
                img = resize_keep_aspect(img, height=output_size[0])
            imwrite(os.path.join(save_dir_img, f'{study_name}_{series_name}_{idx + 1:03d}.png'),
                    img)
        log.info('DICOM %s converted and saved to %s', dcm_path, save_dir_img)


@entry_point('convert_dicoms')
def main(cfg: Config) -> None:
    if cfg.output_type == 'video':
        raise video_not_ported('convert_dicoms output_type=video')
    data_dir, save_dir = os.path.abspath(cfg.data_dir), os.path.abspath(cfg.save_dir)
    study_list = get_dir_list(data_dir, list(cfg.get('include_dirs') or []),
                              list(cfg.get('exclude_dirs') or []))
    with ThreadPoolExecutor(max(os.cpu_count() or 2, 2)) as pool:
        list(pool.map(lambda study_dir: convert_single_study(
            data_dir=study_dir, output_type=cfg.output_type,
            output_size=tuple(cfg.output_size), to_gray=bool(cfg.to_gray), fps=int(cfg.fps),
            save_dir=save_dir), study_list))
    log.info('Complete')


if __name__ == '__main__':
    main()
