"""Device-resident augmentation of training batches (the port of
octseg/ops/augment.py).

The reference's albumentations policy, with the JAX package's probabilities
and ranges (images float32 0..255 BGR, masks float32 {0,1}, NHWC):

  1. HorizontalFlip            p=0.50
  2. ShiftScaleRotate          p=0.20  shift +-6.25%, scale +-10%, rotate +-15 deg
  3. RandomCrop + PadIfNeeded  p=0.20  crop U(0.8,0.9) * size, re-padded centered
  4. GaussNoise                p=0.15  var U(1.5,6.5), per channel
  5. Perspective               p=0.20  corner jitter scale U(0.05,0.1)
  6. RandomBrightnessContrast  p=0.15  +-0.15
  7. HueSaturationValue        p=0.15  h+-15, s+-20, v+-15 (uint8 units)

The work is split in three so that tests can hand both packages the same
numbers:

- ``draw_params(n, h, w, generator)``: every random draw, per sample, from
  an explicit ``torch.Generator`` on the batch's device (the noise too);
- ``geometry(params, h, w)``: the flip, shift-scale-rotate and crop maps
  composed as ``m_pre``, the perspective map ``m_persp`` and the crop's
  validity rectangle ``rect``;
- ``apply_augment(imgs, masks, params)``: deterministic given its inputs.
  One warp by ``m_pre @ m_persp`` (TPU kernel K2's port, the CUDA kernel
  for a CUDA batch and its plain version for a CPU batch), the validity
  mask, then the photometric chain.

The JAX package's quirks are kept: ``_rgb_to_hsv`` runs on BGR data, and
the noise is added after the warp. jax.random and torch draw different
numbers from the same seed, so the two packages agree in distribution, and
exactly when handed the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from octseg_torch.ops.kernels.warp import warp_pair
from octseg_torch.ops.warp import (
    affine_matrix,
    apply_homography,
    matmul3,
    perspective_from_corners,
    pixel_grid,
)

Params = Dict[str, torch.Tensor]

# branch -> probability, in the policy's order
BRANCH_P = {'flip': 0.5, 'ssr': 0.2, 'crop': 0.2, 'noise_on': 0.15, 'persp': 0.2,
            'bc': 0.15, 'hsv': 0.15}


def draw_params(n: int, h: int, w: int, generator: torch.Generator,
                channels: int = 3) -> Params:
    """Per-sample draws of the policy for an (n, h, w, channels) batch, on
    ``generator``'s device. Booleans say whether a branch fires; the other
    values are what octseg's ``_geom_params`` and ``_photometric`` compute
    from their uniform and normal draws."""
    dev = generator.device

    def uniform(lo: float = 0.0, hi: float = 1.0, shape=(n,)) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=dev)
        return u * (hi - lo) + lo

    def normal(shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=dev)

    p: Params = {'flip': uniform() < BRANCH_P['flip'], 'ssr': uniform() < BRANCH_P['ssr']}
    p['shift_x'] = uniform(-0.0625, 0.0625) * w
    p['shift_y'] = uniform(-0.0625, 0.0625) * h
    p['scale'] = 1.0 + uniform(-0.1, 0.1)
    p['angle'] = uniform(-15.0, 15.0) * math.pi / 180.0
    p['crop'] = uniform() < BRANCH_P['crop']
    p['ch'] = torch.floor(uniform(0.8, 0.9) * h)
    p['cw'] = torch.floor(uniform(0.8, 0.9) * w)
    p['y0'] = torch.floor(uniform() * (h - p['ch']))
    p['x0'] = torch.floor(uniform() * (w - p['cw']))
    p['persp'] = uniform() < BRANCH_P['persp']
    p['jitter'] = normal((n, 4, 2)) * uniform(0.05, 0.1)[:, None, None]
    p['noise_on'] = uniform() < BRANCH_P['noise_on']
    p['noise'] = normal((n, h, w, channels)) * torch.sqrt(uniform(1.5, 6.5))[:, None, None, None]
    p['bc'] = uniform() < BRANCH_P['bc']
    p['alpha'] = 1.0 + uniform(-0.15, 0.15)
    p['beta'] = uniform(-0.15, 0.15) * 255.0
    p['hsv'] = uniform() < BRANCH_P['hsv']
    p['h_shift'] = uniform(-15.0, 15.0)
    p['s_shift'] = uniform(-20.0, 20.0)
    p['v_shift'] = uniform(-15.0, 15.0)
    return p


def _select(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per sample: ``a`` where ``flag`` (N,) holds, else ``b``."""
    return torch.where(flag.reshape(-1, *([1] * (a.ndim - 1))), a, b)


def geometry(params: Params, h: int, w: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m_pre, m_persp, rect): (N, 3, 3), (N, 3, 3), (N, 4). m_pre maps crop
    coordinates to source coordinates (flip, then shift-scale-rotate, then
    crop), m_persp output coordinates to crop coordinates; rect is the
    crop's [top, bottom, left, right] in crop coordinates."""
    flip = params['flip']
    n, dev = flip.shape[0], flip.device
    ident = torch.eye(3, device=dev).expand(n, 3, 3)

    m_flip = torch.tensor([[-1.0, 0.0, w - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                          device=dev).expand(n, 3, 3)
    m_flip = _select(flip, m_flip, ident)
    m_ssr = affine_matrix(params['shift_x'], params['shift_y'], params['scale'],
                          params['angle'], (w - 1) / 2.0, (h - 1) / 2.0)
    m_ssr = _select(params['ssr'], m_ssr, ident)

    ch, cw = params['ch'], params['cw']
    pad_top = torch.floor((h - ch) / 2.0)
    pad_left = torch.floor((w - cw) / 2.0)
    m_crop = torch.eye(3, device=dev).repeat(n, 1, 1)
    m_crop[:, 0, 2] = params['x0'] - pad_left
    m_crop[:, 1, 2] = params['y0'] - pad_top
    m_crop = _select(params['crop'], m_crop, ident)
    rect = _select(params['crop'],
                   torch.stack([pad_top, pad_top + ch, pad_left, pad_left + cw], -1),
                   torch.tensor([-1.0, h + 1.0, -1.0, w + 1.0], device=dev).expand(n, 4))

    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
                           device=dev)
    sign = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=dev)
    src_pts = corners + params['jitter'].abs() * sign * torch.tensor([w, h], dtype=torch.float32,
                                                                     device=dev)
    m_persp = _select(params['persp'], perspective_from_corners(src_pts, corners), ident)

    m_pre = matmul3(matmul3(m_flip, m_ssr), m_crop)
    return m_pre, m_persp, rect


def validity(m_persp: torch.Tensor, rect: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W, 1) {0,1}: output pixels whose crop position falls inside
    the crop rectangle."""
    xs, ys = pixel_grid(h, w, m_persp.device)
    cx, cy = apply_homography(m_persp, xs, ys)
    r = [rect[:, i].reshape(-1, 1, 1) for i in range(4)]
    inside = (cy >= r[0] - 0.5) & (cy < r[1] - 0.5) & (cx >= r[2] - 0.5) & (cx < r[3] - 0.5)
    return inside[..., None].to(torch.float32)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[0,255] -> HSV with cv2's uint8 ranges (H in [0,180), S and V in
    [0,255]), on the last axis taken as (r, g, b)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-6) * 255.0, 0.0)
    safe = torch.clamp(delta, min=1e-6)
    hr = (g - b) / safe
    hg = 2.0 + (b - r) / safe
    hb = 4.0 + (r - g) / safe
    hue = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    hue = torch.remainder(hue * 30.0, 180.0)
    hue = torch.where(delta == 0, 0.0, hue)
    return torch.stack([hue, s, maxc], -1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] / 30.0, hsv[..., 1] / 255.0, hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int64), 6)[..., None]
    pick = [(v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q)]
    return torch.cat([torch.stack(c, -1).gather(-1, sector) for c in pick], -1)


def photometric(img: torch.Tensor, params: Params) -> torch.Tensor:
    """Gaussian noise, brightness/contrast, then HSV shifts (steps 4, 6, 7)."""
    per = {k: params[k].reshape(-1, 1, 1, 1) for k in
           ('alpha', 'beta', 'h_shift', 's_shift', 'v_shift')}
    img = _select(params['noise_on'], torch.clamp(img + params['noise'], 0.0, 255.0), img)
    img = _select(params['bc'], torch.clamp(img * per['alpha'] + per['beta'], 0.0, 255.0), img)
    hsv = _rgb_to_hsv(img)
    hsv = torch.stack([torch.remainder(hsv[..., 0] + per['h_shift'][..., 0], 180.0),
                       torch.clamp(hsv[..., 1] + per['s_shift'][..., 0], 0.0, 255.0),
                       torch.clamp(hsv[..., 2] + per['v_shift'][..., 0], 0.0, 255.0)], -1)
    return _select(params['hsv'], torch.clamp(_hsv_to_rgb(hsv), 0.0, 255.0), img)


def apply_augment(imgs: torch.Tensor, masks: torch.Tensor, params: Params
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment (N, H, W, 3) images and (N, H, W, C) masks with the given
    draws; shapes are kept."""
    n, h, w, _ = imgs.shape
    m_pre, m_persp, rect = geometry(params, h, w)
    mats = matmul3(m_pre, m_persp)
    img_w, mask_w = warp_pair(imgs.contiguous(), masks.contiguous(), mats.contiguous())
    inside = validity(m_persp, rect, h, w)
    return photometric(img_w * inside, params), mask_w * inside


def augment_batch(imgs: torch.Tensor, masks: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment a batch with independent per-sample draws from ``generator``
    (which must live on the batch's device)."""
    if generator.device.type != imgs.device.type:
        raise ValueError(f'generator on {generator.device}, batch on {imgs.device}')
    n, h, w, c = imgs.shape
    return apply_augment(imgs, masks, draw_params(n, h, w, generator, c))
