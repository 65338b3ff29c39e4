"""Supervisely video project -> interim dataset (frames + metadata.csv):
the port of octseg/data/convert_sly_to_int.py.

The project layout (``<project>/<dataset>/{ann,frames}/``) and annotation
JSON (frames, figures, objects; polygon exterior points, bitmap origin and
base64 data) are parsed directly. Per figure, the metadata row holds
octseg's columns: image path and name, study, series, slice, image size,
geometry type, class id and name, the bounding box, centre and box size of
the largest external contour (``findContours(RETR_EXTERNAL,
CHAIN_APPROX_NONE)``), its area, and the cropped mask as a base64 bitmap
(the port's own PNG bytes, which decode to octseg's pixels). A frame
without a figure keeps one empty row. Polygons are rasterised as octseg
does, into a local mask one pixel short of the polygon's maximum row and
column, by ``fill_poly`` (cv2.fillPoly).

Frames are read from ``frames/<video name>/*.png``; a series with only a
``video/`` file raises NotImplementedError: the port has no video decoder
(ROADMAP.md, "Video output and reading"). Paths in the config resolve
against the working directory, and ``img_path`` is written relative to it
(octseg: to the repository root).

Config: configs/convert_sly_to_int.yaml. Usage:
python -m octseg_torch.data.convert_sly_to_int [key=value ...]
"""

from __future__ import annotations

import json
import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from octseg_torch.analyze.contours import contour_areas, find_contours
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.core.table import Table
from octseg_torch.data.convert_dicoms import VIDEO_ITEM
from octseg_torch.data.draw import fill_poly
from octseg_torch.data.io import imread, imwrite
from octseg_torch.data.utils import convert_base64_to_numpy, convert_numpy_to_base64

log = logging.getLogger(__name__)

META_COLUMNS = [
    'img_path', 'img_name', 'study', 'series', 'slice', 'img_width',
    'img_height', 'type', 'class_id', 'class_name', 'x1', 'y1', 'x2', 'y2',
    'xc', 'yc', 'box_width', 'box_height', 'area', 'encoded_mask',
]


def polygon_to_mask(polygon: List[List[int]]) -> Tuple[int, int, np.ndarray]:
    """(x_min, y_min, mask): the polygon filled into a local mask of
    (y_max - y_min, x_max - x_min) pixels, so its pixels on the maximum row
    and column are clipped (the published folds were built so)."""
    xs = [v[0] for v in polygon]
    ys = [v[1] for v in polygon]
    x_min, x_max = min(xs), max(xs)
    y_min, y_max = min(ys), max(ys)
    pts = np.array(polygon, dtype=np.int32) - (x_min, y_min)
    mask = np.zeros((y_max - y_min, x_max - x_min), dtype=np.uint8)
    if mask.size:  # an axis-aligned line gives an empty mask
        fill_poly(mask, [pts], 1)
    return x_min, y_min, mask


def figure_to_mask_properties(figure: dict, frame_size: Tuple[int, int],
                              crop: List[List[int]]) -> Optional[Tuple[str, int, List[List[int]]]]:
    """Full-frame paste and crop -> (encoded mask, contour area, bbox), or
    None for another geometry or a mask empty after the crop."""
    geom = figure['geometryType']
    if geom == 'polygon':
        x_min, y_min, obj = polygon_to_mask(figure['geometry']['points']['exterior'])
    elif geom == 'bitmap':
        x_min, y_min = figure['geometry']['bitmap']['origin']
        obj = convert_base64_to_numpy(figure['geometry']['bitmap']['data']).astype(np.uint8)
    else:
        return None
    mask = np.zeros(frame_size, dtype=np.uint8)
    mask[y_min:y_min + obj.shape[0], x_min:x_min + obj.shape[1]] = obj
    mask = mask[crop[0][1]:crop[1][1], crop[0][0]:crop[1][0]]
    contours = find_contours(mask, 'external', 'none')
    if not contours:
        return None
    areas = contour_areas(contours)
    best = int(np.argmax(areas))   # the first of equal areas, as max() picks
    pts = contours[best].reshape(-1, 2)  # (x, y)
    bbox = [[int(pts[:, 0].min()), int(pts[:, 1].min())],
            [int(pts[:, 0].max()), int(pts[:, 1].max())]]
    return convert_numpy_to_base64(mask.astype(bool)), int(areas[best]), bbox


def get_series_id(filename: str) -> int:
    match = re.search(r'_(\d+)\.mp4', filename)
    if not match:
        raise ValueError('No match found')
    return int(match.group(1))


def _dataset_videos(dataset_dir: str) -> List[str]:
    """Video item names of a dataset, from its annotation files
    (ann/<video name>.json)."""
    return sorted(os.path.basename(p)[: -len('.json')]
                  for p in glob(os.path.join(dataset_dir, 'ann', '*.mp4.json')))


def process_single_annotation(dataset_dir: str, img_dir: str, class_ids: Dict[str, int],
                              crop: List[List[int]]) -> List[dict]:
    """The metadata rows of one dataset (one per figure; one empty row for
    a frame without any)."""
    study = os.path.basename(dataset_dir.rstrip('/'))
    rows: List[dict] = []
    for video_name in _dataset_videos(dataset_dir):
        series = get_series_id(video_name)
        with open(os.path.join(dataset_dir, 'ann', f'{video_name}.json')) as f:
            ann = json.load(f)
        objects = {o['key']: o for o in ann.get('objects', [])}
        frames = {fr['index']: fr for fr in ann.get('frames', [])}
        for idx in range(ann['framesCount']):
            slice_str = f'{idx + 1:03d}'
            img_name = f'{study}_{series}_{slice_str}.png'
            base = dict.fromkeys(META_COLUMNS)
            base.update(img_path=os.path.join(img_dir, img_name), img_name=img_name,
                        study=study, series=series, slice=slice_str,
                        img_width=crop[1][0] - crop[0][0], img_height=crop[1][1] - crop[0][1])
            frame = frames.get(idx)
            if not frame or not frame.get('figures'):
                rows.append(base)
                continue
            n_before = len(rows)
            for figure in frame['figures']:
                props = figure_to_mask_properties(
                    figure, (ann['size']['height'], ann['size']['width']), crop)
                if props is None:   # skip this figure only
                    continue
                encoded, area, bbox = props
                class_name = objects[figure['objectKey']]['classTitle']
                row = dict(base)
                row.update(
                    type=figure['geometryType'], class_id=class_ids[class_name],
                    class_name=class_name,
                    x1=bbox[0][0], y1=bbox[0][1], x2=bbox[1][0], y2=bbox[1][1],
                    xc=int(np.mean([bbox[0][0], bbox[1][0]])),
                    yc=int(np.mean([bbox[0][1], bbox[1][1]])),
                    box_width=bbox[1][0] - bbox[0][0] + 1,
                    box_height=bbox[1][1] - bbox[0][1] + 1,
                    area=area, encoded_mask=encoded)
                rows.append(row)
            if len(rows) == n_before:  # every figure skipped: one empty row
                rows.append(base)
    return rows


def process_single_video(dataset_dir: str, img_dir: str, crop: List[List[int]]) -> None:
    """Write each series' frames, cropped, as ``<study>_<series>_<NNN>.png``
    (read from ``frames/<video name>/``)."""
    study = os.path.basename(dataset_dir.rstrip('/'))
    for video_name in _dataset_videos(dataset_dir):
        series = get_series_id(video_name)
        frames_dir = os.path.join(dataset_dir, 'frames', video_name)
        if not os.path.isdir(frames_dir):
            raise NotImplementedError(
                f'{os.path.join(dataset_dir, "video", video_name)}: octseg_torch reads a '
                f'series from frames/{video_name}/ only; it has no video decoder '
                f'({VIDEO_ITEM})')
        for i, p in enumerate(sorted(glob(os.path.join(frames_dir, '*.png'))), 1):
            img = imread(p)[crop[0][1]:crop[1][1], crop[0][0]:crop[1][0], :]
            imwrite(os.path.join(img_dir, f'{study}_{series}_{i:03d}.png'), img)


@entry_point('convert_sly_to_int')
def main(cfg: Config) -> None:
    data_dir, save_dir = os.path.abspath(cfg.data_dir), os.path.abspath(cfg.save_dir)
    img_dir = os.path.join(save_dir, 'img')
    os.makedirs(img_dir, exist_ok=True)
    crop = [list(c) for c in cfg.crop]
    # dataset dirs: subdirectories holding ann/ (and frames/)
    datasets = sorted(d for d in glob(os.path.join(data_dir, '*/'))
                      if os.path.isdir(os.path.join(d, 'ann')))
    with ThreadPoolExecutor(max(os.cpu_count() or 2, 2)) as pool:
        list(pool.map(lambda d: process_single_video(d, img_dir, crop), datasets))
        parts = list(pool.map(lambda d: Table.from_rows(
            META_COLUMNS, process_single_annotation(d, img_dir, CLASS_IDS, crop)), datasets))
    table = Table.concat(parts) if parts else Table.from_rows(META_COLUMNS, [])
    table = table.sort_values(['img_path', 'class_id'])
    cwd = os.getcwd()
    table.data['img_path'] = [os.path.relpath(p, cwd) for p in table.data['img_path']]
    table.to_csv(os.path.join(save_dir, 'metadata.csv'), index_label='id')
    log.info('Complete')


if __name__ == '__main__':
    main()
