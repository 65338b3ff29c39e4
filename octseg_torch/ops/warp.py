"""Projective warping of image/mask batches (the port of octseg/ops/warp.py).

``matrix`` maps output pixel coordinates (x, y, 1) to input coordinates
(inverse mapping). Batches are NHWC float32, the JAX package's layout.

- ``affine_matrix`` / ``perspective_from_corners``: the augmentation's
  shift-scale-rotate and four-corner perspective maps, batched;
- ``apply_homography``: the elementwise transform of pixel coordinates,
  in octseg's operation order (each product and sum rounded on its own);
- ``sample_pair_at`` / ``sample_pair_plain``: the plain torch version of TPU
  kernel K2 (``octseg/ops/pallas/resample.py``). Its semantics are those of
  ``_sample_pair_fused`` (``octseg/ops/warp.py``), the parity target the TPU
  kernel names: bilinear images, nearest masks (the tap the fractional
  parts round half up to), taps rounded to bfloat16 and summed in float32,
  a zero border (half-outside taps read 0, positions with floor outside
  [-1, size - 1] give 0). ``ops/kernels/warp.py`` launches the CUDA kernel
  on the card and holds it against this version.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def affine_matrix(shift_x, shift_y, scale, angle_rad, center_x: float,
                  center_y: float) -> torch.Tensor:
    """(..., 3, 3) inverse-mapping matrices of a shift + scale + rotation
    about (center_x, center_y), from float32 tensors of per-sample values.
    A positive angle turns counter-clockwise in image (y-down) coordinates,
    as cv2.getRotationMatrix2D."""
    cos = torch.cos(angle_rad) / scale
    sin = -torch.sin(angle_rad) / scale
    m00, m01, m10, m11 = cos, sin, -sin, cos
    tx = center_x - m00 * (center_x + shift_x) - m01 * (center_y + shift_y)
    ty = center_y - m10 * (center_x + shift_x) - m11 * (center_y + shift_y)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([torch.stack([m00, m01, tx], -1), torch.stack([m10, m11, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def perspective_from_corners(src_pts: torch.Tensor, dst_pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) homographies mapping ``dst_pts`` to ``src_pts`` (each
    (..., 4, 2) float32): the 8x8 DLT system, solved in float32."""
    src_pts, dst_pts = torch.broadcast_tensors(src_pts, dst_pts)
    x, y = dst_pts[..., 0], dst_pts[..., 1]
    u, v = src_pts[..., 0], src_pts[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    a_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    a_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    a = torch.cat([a_u, a_v], -2)
    b = torch.cat([u, v], -1)
    # solve_ex: no check for a singular system, which would wait for the
    # device (jnp.linalg.solve does not check either)
    h = torch.linalg.solve_ex(a, b).result
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*h.shape[:-1], 3, 3)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product in plain float32 arithmetic (never TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def apply_homography(m: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sx, sy) for (N, 3, 3) matrices and coordinates broadcastable to
    (N, H, W); elementwise, in the order of octseg.ops.augment."""
    e = [m[:, i, j].reshape(-1, 1, 1) for i in range(3) for j in range(3)]
    px = e[0] * xs + e[1] * ys + e[2]
    py = e[3] * xs + e[4] * ys + e[5]
    pw = e[6] * xs + e[7] * ys + e[8]
    return px / pw, py / pw


def pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys), each (H, W) float32 pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing='ij')
    return xs, ys


def sample_pair_at(imgs: torch.Tensor, masks: torch.Tensor, sx: torch.Tensor,
                   sy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear ``imgs`` (N, H, W, Ci) and nearest ``masks`` (N, H, W, Cm) at
    source positions ``sx, sy`` (N, H', W'): the semantics of
    ``_sample_pair_fused``, one gather of the four taps of both tensors."""
    n, h, w, ci = imgs.shape
    packed = torch.cat([imgs, masks], -1).to(torch.bfloat16).to(torch.float32)
    c = packed.shape[-1]
    # zero border of 1 before and 2 after: the taps of (y, x) start at
    # padded (y + 1, x + 1)
    p = F.pad(packed, (0, 0, 1, 2, 1, 2))
    qw = w + 3
    flat = p.reshape(n, -1, c)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    valid = ((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1))[..., None]
    # any in-range index for invalid positions (their output is 0)
    xi = torch.where(valid[..., 0], x0, -1.0).to(torch.int64) + 1
    yi = torch.where(valid[..., 0], y0, -1.0).to(torch.int64) + 1
    base = (yi * qw + xi).reshape(n, -1)

    def tap(offset: int) -> torch.Tensor:
        idx = (base + offset)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*sx.shape, c)

    t00, t01, t10, t11 = tap(0), tap(1), tap(qw), tap(qw + 1)
    top = t00[..., :ci] * (1 - wx) + t01[..., :ci] * wx
    bot = t10[..., :ci] * (1 - wx) + t11[..., :ci] * wx
    out_img = torch.where(valid, top * (1 - wy) + bot * wy, 0.0)
    right, down = wx >= 0.5, wy >= 0.5
    out_mask = torch.where(down, torch.where(right, t11, t10), torch.where(right, t01, t00))
    return out_img, torch.where(valid, out_mask[..., ci:], 0.0)


def sample_pair_plain(imgs: torch.Tensor, masks: torch.Tensor, mats: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2: warp (N, H, W, Ci) images and (N, H, W, Cm)
    masks by (N, 3, 3) inverse homographies."""
    xs, ys = pixel_grid(imgs.shape[1], imgs.shape[2], imgs.device)
    sx, sy = apply_homography(mats, xs, ys)
    return sample_pair_at(imgs, masks, sx, sy)
