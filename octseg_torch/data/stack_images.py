"""Side-by-side stacker: paired RGB and grayscale series -> hstacked PNGs
(the port of octseg/data/stack_images.py, image output).

Each pair of series directories (the RGB and the gray conversion of one
series) is read frame by frame in file order, each panel resized to
``output_size``'s height where its size differs, and written as
``<save_dir>/<study>/<series>/<study>_<series>_<NNN>.png``, the pixels
cv2's read and write keep. Video output raises NotImplementedError
(ROADMAP.md, "Video output and reading").

Paths resolve against the working directory, as in octseg.

Config: configs/stack_images.yaml (its default ``output_type`` is video:
pass ``output_type=image``). Usage:
python -m octseg_torch.data.stack_images [key=value ...]
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from pathlib import Path
from typing import List

import numpy as np

from octseg_torch.core.config import Config, entry_point
from octseg_torch.data.convert_dicoms import resize_keep_aspect, video_not_ported
from octseg_torch.data.io import imread, imwrite
from octseg_torch.data.utils import get_dir_list, get_file_list

log = logging.getLogger(__name__)


def process_single_series(series_dirs: List[str], img_height: int, img_width: int,
                          output_type: str, fps: int, save_dir: str) -> None:
    """Stack the frames of ``series_dirs`` side by side."""
    if output_type == 'video':
        raise video_not_ported('stack_images output_type=video')
    if output_type != 'image':
        raise ValueError(f'Unknown output_type value: {output_type}')
    series_name = Path(series_dirs[0]).parts[-1]
    study_name = Path(series_dirs[0]).parts[-2]
    save_dir_img = os.path.join(save_dir, study_name, series_name)
    os.makedirs(save_dir_img, exist_ok=True)
    img_lists = [get_file_list(src_dirs=d, ext_list='.png') for d in series_dirs]
    for idx, img_paths in enumerate(zip(*img_lists)):
        panels = []
        for img_path in img_paths:
            img = imread(img_path)
            if img.shape[0] != img_height or img.shape[1] != img_width:
                img = resize_keep_aspect(img, height=img_height)
            panels.append(img)
        imwrite(os.path.join(save_dir_img, f'{study_name}_{series_name}_{idx + 1:03d}.png'),
                np.hstack(panels))
    log.info('Series %s/%s saved to %s', study_name, series_name, save_dir_img)


def _all_series(data_dir: str, include, exclude) -> List[str]:
    studies = get_dir_list(data_dir, include, exclude)
    return sum((sorted(glob(s + '*/')) for s in studies), [])


@entry_point('stack_images')
def main(cfg: Config) -> None:
    if cfg.output_type == 'video':
        raise video_not_ported('stack_images output_type=video')
    series_rgb = _all_series(cfg.data_dir_1, cfg.get('include_dirs'), cfg.get('exclude_dirs'))
    series_gray = _all_series(cfg.data_dir_2, cfg.get('include_dirs'), cfg.get('exclude_dirs'))
    assert len(series_rgb) == len(series_gray), 'Mismatch number of series'
    with ThreadPoolExecutor(max(os.cpu_count() or 2, 2)) as pool:
        list(pool.map(lambda p: process_single_series(
            series_dirs=list(p), img_height=cfg.output_size[0], img_width=cfg.output_size[1],
            output_type=cfg.output_type, fps=int(cfg.fps), save_dir=cfg.save_dir),
            zip(series_rgb, series_gray)))
    log.info('Complete')


if __name__ == '__main__':
    main()
