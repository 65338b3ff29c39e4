"""Synthetic labeled OCT-like data: images with exact ground-truth masks.

A copy of octseg/data/synth.py (the port imports nothing of octseg): the
same draws from the same generator give the same arrays; images are written
with the port's PNG writer (channels reversed, as cv2.imwrite takes BGR) and
masks with its TIFF writer, so a fold decodes to octseg's arrays.

The real dataset (103 patients / 25,698 frames, reference dvc.lock) lives on
an unreachable DVC remote, so segmentation accuracy is demonstrated on a
procedurally generated stand-in whose appearance mimics the four plaque
features the reference segments (reference: src/data/utils.py:16-33 class map):

- Lumen (id 1): dark disk at the vessel center,
- Fibrous cap (id 2): thin bright arc at the inner wall over the lipid sector,
- Lipid core (id 3): diffuse dark arc inside the bright wall,
- Vasa vasorum (id 4): small bright dots outside the wall.

Each feature has an unambiguous intensity/texture cue, so a correct
segmentation stack must be able to learn it to high DSC — this powers the
convergence proof of octseg's tests and scripts.

Layout written by make_synth_fold matches the CV-fold contract consumed by
OCTDataset (reference: src/models/smp/dataset.py — {split}/{img,mask},
mask TIFF channels = class_id - 1, values {0,255}).
"""

from __future__ import annotations

import os

import numpy as np

from octseg_torch.data.image import write_png
from octseg_torch.data.tiffio import write_tiff


def synth_labeled_sample(rng: np.random.Generator, size: int):
    """One (img uint8 (S,S,3) BGR-ish, mask uint8 (S,S,4) {0,255}) pair."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    cy = size / 2 + rng.uniform(-0.06, 0.06) * size
    cx = size / 2 + rng.uniform(-0.06, 0.06) * size
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    theta = np.arctan2(yy - cy, xx - cx)

    lumen_r = size * rng.uniform(0.10, 0.20)
    wall_w = size * rng.uniform(0.10, 0.16)
    wall_outer = lumen_r + wall_w

    mask = np.zeros((size, size, 4), np.uint8)
    img = np.zeros((size, size), np.float32)

    # Bright vessel wall annulus on a dim speckled background.
    speckle = rng.gamma(2.0, 0.5, (size, size)).clip(0, 4).astype(np.float32) / 4
    img += 25 * speckle
    in_wall = (r >= lumen_r) & (r < wall_outer)
    img[in_wall] = 150 + 40 * speckle[in_wall]

    # Lumen: dark interior disk.
    in_lumen = r < lumen_r
    img[in_lumen] = 8 + 14 * speckle[in_lumen]
    mask[:, :, 0] = np.where(in_lumen, 255, 0)

    # Lipid sector: a dark diffuse arc occupying the outer wall, capped by a
    # thin very bright fibrous band at the inner wall over the same angles.
    a0 = rng.uniform(-np.pi, np.pi)
    da = rng.uniform(np.pi / 3, 0.8 * np.pi)
    ang = np.mod(theta - a0, 2 * np.pi)
    in_sector = ang < da
    cap_w = size * rng.uniform(0.02, 0.035)
    in_cap = in_sector & (r >= lumen_r) & (r < lumen_r + cap_w)
    in_lipid = in_sector & (r >= lumen_r + cap_w) & (r < wall_outer)
    img[in_lipid] = 55 + 25 * speckle[in_lipid]
    img[in_cap] = 225 + 25 * speckle[in_cap]
    mask[:, :, 1] = np.where(in_cap, 255, 0)
    mask[:, :, 2] = np.where(in_lipid, 255, 0)

    # Vasa vasorum: 2-5 bright dots outside the wall.
    vv = np.zeros((size, size), bool)
    for _ in range(rng.integers(2, 6)):
        vr = size * rng.uniform(0.015, 0.03)
        vd = wall_outer + vr + rng.uniform(0.02, 0.18) * size
        va = rng.uniform(-np.pi, np.pi)
        vy, vx = cy + vd * np.sin(va), cx + vd * np.cos(va)
        if not (vr <= vy < size - vr and vr <= vx < size - vr):
            continue
        dot = (yy - vy) ** 2 + (xx - vx) ** 2 < vr ** 2
        vv |= dot
    img[vv] = 210 + 30 * speckle[vv]
    mask[:, :, 3] = np.where(vv, 255, 0)

    # Mild radial vignette + clip, then a slightly colored 3-channel stack.
    img *= 1 - 0.15 * np.exp(-(r / (size * 0.5)) ** 2)
    img = np.clip(img, 0, 255).astype(np.uint8)
    img3 = np.stack(
        [img, (img * 0.85).astype(np.uint8), (img * 0.65).astype(np.uint8)],
        axis=-1,
    )
    return img3, mask


def make_synth_fold(
    out_dir: str,
    n_train: int,
    n_test: int,
    size: int = 256,
    seed: int = 11,
    n_vis: int = 0,
) -> None:
    """Write a CV-fold-shaped synthetic dataset: {train,test}/{img,mask}."""
    rng = np.random.default_rng(seed)
    splits = [('train', n_train), ('test', n_test)]
    if n_vis:
        splits.append(('vis', n_vis))
    for split, count in splits:
        img_dir = os.path.join(out_dir, split, 'img')
        mask_dir = os.path.join(out_dir, split, 'mask')
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        for i in range(count):
            img, mask = synth_labeled_sample(rng, size)
            stem = f'{split}_{i + 1:04d}'
            write_png(os.path.join(img_dir, f'{stem}.png'), np.ascontiguousarray(img[..., ::-1]))
            write_tiff(os.path.join(mask_dir, f'{stem}.tiff'), mask)
