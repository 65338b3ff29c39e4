"""Host-side dataset and threaded prefetch loader (the port of
octseg/train/data.py).

Same semantics as the JAX package:
- pairs {data_dir}/mask/*.tiff with {data_dir}/img/{stem}.png;
- a pair is kept only if a selected class channel holds a value > 1;
- image: BGR uint8 (``read_png``, cv2.imread's result), resized with cv2's
  INTER_LINEAR (``resize_linear_u8``), returned float32 0..255;
- mask: channel = class_id - 1, resized INTER_NEAREST, binarized, float32.

Batches stay NHWC numpy arrays; the trainer moves them to the device and
augments them there.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.data.image import read_png, resize_linear_u8, resize_nearest_u8
from octseg_torch.data.tiffio import read_tiff

log = logging.getLogger(__name__)


class OCTDataset:
    """Index of verified image/mask pairs for one split directory."""

    def __init__(self, data_dir: str, classes: Sequence[str], input_size: int = 512,
                 num_workers: Optional[int] = None):
        self.classes = list(classes)
        self.class_ids = [CLASS_IDS[cl] for cl in self.classes]
        self.input_size = input_size
        mask_paths = sorted(glob(os.path.join(data_dir, 'mask', '*.tiff')))
        workers = num_workers or max((os.cpu_count() or 2) // 2, 1)
        with ThreadPoolExecutor(workers) as pool:
            pairs = list(pool.map(
                lambda p: self._verify_pair(os.path.join(data_dir, 'img'), p), mask_paths))
        pairs = [p for p in pairs if p is not None]
        if not pairs:
            raise ValueError(f'No correct data found in {data_dir}')
        log.info('Number of image-mask pairs: %d', len(pairs))
        self.img_paths, self.mask_paths = zip(*pairs)

    def _verify_pair(self, img_dir: str, mask_path: str):
        img_path = os.path.join(img_dir, f'{Path(mask_path).stem}.png')
        if not os.path.exists(img_path):
            log.warning('Image: %s does not exist', img_path)
            return None
        mask = read_tiff(mask_path)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        for class_id in self.class_ids:
            if np.any(mask[:, :, class_id - 1] > 1):
                return img_path, mask_path
        return None

    def __len__(self) -> int:
        return len(self.img_paths)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """One (img float32 BGR [0,255] HWC, mask float32 {0,1} HWC) pair."""
        size = (self.input_size, self.input_size)
        img = resize_linear_u8(read_png(self.img_paths[idx]), size)
        mask = resize_nearest_u8(read_tiff(self.mask_paths[idx]), size)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        channels = [mask[:, :, cid - 1].astype(bool) for cid in self.class_ids]
        mask = np.stack(channels, axis=-1).astype(np.float32)
        return img.astype(np.float32), mask


class PrefetchLoader:
    """Threaded batch producer with lookahead: the next ``prefetch`` + 1
    batches decode on a thread pool while the trainer consumes one."""

    def __init__(self, dataset: OCTDataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: Optional[int] = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers or max((os.cpu_count() or 2) - 1, 1)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        batches = []
        for i in range(0, n, self.batch_size):
            chunk = order[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            batches.append(chunk)
        return batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        batches = self._batch_indices()
        self.epoch += 1

        def make_batch(idxs: np.ndarray):
            pairs = [self.dataset.load(int(i)) for i in idxs]
            return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

        with ThreadPoolExecutor(self.num_workers) as pool:
            futures = []
            lookahead = self.prefetch + 1
            for b in batches[:lookahead]:
                futures.append(pool.submit(make_batch, b))
            next_submit = lookahead
            for i in range(len(batches)):
                yield futures[i].result()
                futures[i] = None
                if next_submit < len(batches):
                    futures.append(pool.submit(make_batch, batches[next_submit]))
                    next_submit += 1
