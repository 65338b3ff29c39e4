"""Interim dataset -> 5-fold cross-validation dataset (the port of
octseg/data/convert_int_to_cv.py), without pandas or sklearn.

Class filtering, a study-level KFold (sklearn's ``KFold(n_splits,
shuffle=True, random_state=seed)`` written out: ``RandomState(seed)``
permutes the study indices, folds take ``n // k`` of them, the first
``n % k`` one more, each split's studies in their first-seen order), per
image multi-channel {0, 255} masks from the encoded object masks with
optional refinement (``mask_processor``), colourised masks, the elliptical
crop (``fill_ellipse``, cv2.ellipse), LZW mask TIFFs and the merged per-fold
``metadata.csv``, byte-equal to octseg's pandas output (``core/table.py``).

Paths in the config resolve against the working directory, as relative
``img_path`` values of the interim metadata do (octseg: the repository
root).

Config: configs/convert_int_to_cv.yaml. Usage:
python -m octseg_torch.data.convert_int_to_cv [key=value ...]
"""

from __future__ import annotations

import functools
import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.registry import CLASS_COLORS_RGB, CLASS_IDS
from octseg_torch.core.table import Table, _is_na
from octseg_torch.data.draw import fill_ellipse
from octseg_torch.data.io import imread, imwrite
from octseg_torch.data.mask_processor import MaskProcessor
from octseg_torch.data.tiffio import write_tiff
from octseg_torch.data.utils import convert_base64_to_numpy

log = logging.getLogger(__name__)


def create_data_directories(num_folds: int, save_dir: str, save_color_mask: bool = True
                            ) -> None:
    dir_types = ['img', 'mask', 'mask_color'] if save_color_mask else ['img', 'mask']
    for fold_idx in range(1, num_folds + 1):
        for subset in ('train', 'test'):
            for dir_type in dir_types:
                (Path(save_dir) / f'fold_{fold_idx}' / subset / dir_type).mkdir(
                    parents=True, exist_ok=True)


def _rows_where(table: Table, keep: Sequence[bool]) -> Table:
    return table.take([i for i, k in enumerate(keep) if k])


def process_metadata(table: Table, classes: Optional[List[str]] = None) -> Table:
    """Rows of the chosen classes (all classes for None), rows without a
    class dropped."""
    names = table.column('class_name')
    keep = [not _is_na(n) and (classes is None or n in classes) for n in names]
    out = _rows_where(table, keep)
    if not len(out):
        raise ValueError('class/exclude filters left no rows in the metadata')
    return out


def kfold_indices(n: int, num_folds: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """sklearn's ``KFold(num_folds, shuffle=True, random_state=seed).split``
    over ``n`` samples: (train indices, test indices) per fold, each
    ascending."""
    if num_folds > n:
        raise ValueError(f'Cannot have number of splits n_splits={num_folds} greater than '
                         f'the number of samples: n_samples={n}.')
    order = np.random.RandomState(seed).permutation(n)
    sizes = np.full(num_folds, n // num_folds, dtype=int)
    sizes[:n % num_folds] += 1
    out, start = [], 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        out.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return out


def cross_validation_split(table: Table, split_column: str, num_folds: int, seed: int
                           ) -> List[Tuple[Table, Table]]:
    """Study-level KFold: every row of a study lands in the same split."""
    ids = table.unique(split_column)
    col = table.column(split_column)
    splits = []
    for train_idx, test_idx in kfold_indices(len(ids), num_folds, seed):
        train_ids = {ids[i] for i in train_idx}
        test_ids = {ids[i] for i in test_idx}
        splits.append((_rows_where(table, [v in train_ids for v in col]),
                       _rows_where(table, [v in test_ids for v in col])))
    return splits


def update_metadata(train: Table, test: Table, fold_idx: int) -> Table:
    """The fold's rows with 'split' and 'fold' columns, without id,
    encoded_mask and type, sorted by image name and class id."""
    parts = []
    for part, split in ((train, 'train'), (test, 'test')):
        part = part.take(range(len(part)))
        part.add_column('split', split)
        part.add_column('fold', fold_idx)
        parts.append(part)
    merged = Table.concat(parts).drop(['id', 'encoded_mask', 'type'])
    return merged.sort_values(['img_name', 'class_id'])


def colorize_mask(mask: np.ndarray, classes: List[str],
                  background: Tuple[int, int, int] = (128, 128, 128)) -> np.ndarray:
    mask_color = np.zeros((mask.shape[0], mask.shape[1], 3), dtype=np.uint8)
    mask_color[:] = background
    for class_name in classes:
        channel_id = CLASS_IDS[class_name] - 1
        mask_color[mask[:, :, channel_id] == 255] = CLASS_COLORS_RGB[class_name]
    return mask_color


@functools.lru_cache(maxsize=8)
def _inside_ellipse(shape: Tuple[int, int], crop: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """The filled ellipse inscribed in the crop rectangle, as bool."""
    (x1, y1), (x2, y2) = crop
    center = ((x1 + x2) // 2, (y1 + y2) // 2)
    radii = (abs(x2 - x1) // 2, abs(y2 - y1) // 2)
    inside = fill_ellipse(np.zeros(shape, np.uint8), center, radii, 255) > 0
    inside.flags.writeable = False
    return inside


def apply_circle_crop(img: np.ndarray, crop: List[List[int]],
                      background: Union[Tuple[int, ...], int] = 0) -> np.ndarray:
    """Everything outside the ellipse inscribed in the crop rectangle set to
    ``background``, then cropped to the rectangle."""
    (x1, y1), (x2, y2) = crop
    inside = _inside_ellipse(img.shape[:2], ((x1, y1), (x2, y2)))
    if isinstance(background, int):
        background = (background,) * img.shape[2]
    img, inside = img[y1:y2, x1:x2], inside[y1:y2, x1:x2]
    return np.where(inside[..., None], img, np.asarray(background, img.dtype))


def process_pair(rows: List[Dict], save_dir: str, crop: Optional[List[List[int]]],
                 classes: List[str], smooth_mask: bool = True, save_color_mask: bool = True
                 ) -> None:
    """One image's rows (its objects) -> img PNG, mask TIFF (channel =
    class id - 1) and colour mask TIFF under ``save_dir``."""
    if not rows:
        return
    img_path = rows[0]['img_path']
    img = imread(img_path)
    h, w = img.shape[:2]
    mask = np.zeros((h, w, max(CLASS_IDS[c] for c in classes)), dtype=np.uint8)
    processor = MaskProcessor() if smooth_mask else None
    for obj in rows:
        obj_mask = convert_base64_to_numpy(obj['encoded_mask']).astype(np.uint8)
        if smooth_mask:
            obj_mask = processor.smooth_mask(obj_mask)
            obj_mask = processor.remove_artifacts(obj_mask)
        mask[:, :, CLASS_IDS[obj['class_name']] - 1][obj_mask == 1] = 255
    mask_color = colorize_mask(mask, classes)
    if crop is not None:
        img = apply_circle_crop(img, crop, background=0)
        mask = apply_circle_crop(mask, crop, background=0)
        mask_color = apply_circle_crop(mask_color, crop, background=128)
    basename = Path(img_path).stem
    imwrite(os.path.join(save_dir, 'img', f'{basename}.png'), img)
    write_tiff(os.path.join(save_dir, 'mask', f'{basename}.tiff'), mask, compression='lzw')
    if save_color_mask:
        write_tiff(os.path.join(save_dir, 'mask_color', f'{basename}.tiff'), mask_color,
                   compression='lzw')


def _process_job(job: Tuple[List[Dict], str], **kwargs) -> None:
    rows, save_dir = job
    process_pair(rows, save_dir, **kwargs)


def _groups(table: Table, key: str) -> List[List[Dict]]:
    """Rows grouped by ``key``, groups in sorted key order."""
    groups: Dict = {}
    for row in table.rows():
        groups.setdefault(row[key], []).append(row)
    return [groups[k] for k in sorted(groups)]


@entry_point('convert_int_to_cv')
def main(cfg: Config) -> None:
    data_dir, save_dir = os.path.abspath(cfg.data_dir), os.path.abspath(cfg.save_dir)
    classes = list(cfg.classes)
    crop = [list(c) for c in cfg.crop] if cfg.get('crop') is not None else None
    create_data_directories(cfg.num_folds, save_dir, cfg.get('save_color_mask', True))
    table = Table.read_csv(os.path.join(data_dir, 'metadata.csv'))
    cwd = os.getcwd()
    table.data['img_path'] = [p if os.path.isabs(p) else os.path.join(cwd, p)
                              for p in table.data['img_path']]
    filtered = process_metadata(table, classes)
    splits = cross_validation_split(filtered, cfg.get('split_column', 'study'), cfg.num_folds,
                                    cfg.get('seed', 11))
    parts, jobs = [], []
    for fold_idx, (train, test) in enumerate(splits, start=1):
        parts.append(update_metadata(train, test, fold_idx))
        log.info('Fold %d - train studies/images: %d/%d, test: %d/%d', fold_idx,
                 len(train.unique('study')), len(train.unique('img_path')),
                 len(test.unique('study')), len(test.unique('img_path')))
        for subset, part in (('train', train), ('test', test)):
            jobs += [(g, f'{save_dir}/fold_{fold_idx}/{subset}') for g in _groups(part, 'img_path')]
    # one process per core: the refinement and fills hold the interpreter
    # lock, so threads (octseg's) would not run them in parallel
    work = functools.partial(_process_job, crop=crop, classes=classes,
                             smooth_mask=cfg.get('smooth_mask', True),
                             save_color_mask=cfg.get('save_color_mask', True))
    with ProcessPoolExecutor(max(os.cpu_count() or 2, 2),
                             mp_context=multiprocessing.get_context('spawn')) as pool:
        list(pool.map(work, jobs, chunksize=max(1, len(jobs) // (8 * (os.cpu_count() or 2)))))
    Table.concat(parts).to_csv(os.path.join(save_dir, 'metadata.csv'), index_label='id')
    log.info('Complete')


if __name__ == '__main__':
    main()
