"""Binary morphology and blur with OpenCV border semantics, in plain torch
(the port of octseg/ops/morphology.py).

Binary masks make morphology a convolution: dilate(x, SE) = conv(x, SE) > 0
with a zero border (cv2's -inf border for dilation); erode(x, SE) =
conv(x, SE) == sum(SE) with a ones border (cv2's +inf border for erosion).
GaussianBlur 5x5 is separable with the REFLECT_101 border (torch's
``'reflect'`` padding). These ops make up the plain version of the fused
overlay postprocess kernel (ops/kernels/postprocess.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5)): 17 taps
ELLIPSE_5 = np.array(
    [
        [0, 0, 1, 0, 0],
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1],
        [0, 0, 1, 0, 0],
    ],
    dtype=np.float32,
)

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 7)): 33 taps
ELLIPSE_7 = np.array(
    [
        [0, 0, 0, 1, 0, 0, 0],
        [0, 1, 1, 1, 1, 1, 0],
        [1, 1, 1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1, 1, 1],
        [0, 1, 1, 1, 1, 1, 0],
        [0, 0, 0, 1, 0, 0, 0],
    ],
    dtype=np.float32,
)

# cv2.getGaussianKernel(5, 0): binomial taps
GAUSS_5 = np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], dtype=np.float32)


def _conv2d_same(x: torch.Tensor, kernel: np.ndarray, pad_value: float) -> torch.Tensor:
    """Single-channel 2D conv over (..., H, W) with a constant border."""
    shape = x.shape
    x2 = x.reshape(-1, 1, shape[-2], shape[-1])
    ph, pw = kernel.shape[0] // 2, kernel.shape[1] // 2
    x2 = F.pad(x2, (pw, pw, ph, ph), mode='constant', value=pad_value)
    k = torch.from_numpy(kernel).to(x.device, x.dtype)[None, None]
    return F.conv2d(x2, k).reshape(shape)


def dilate(mask: torch.Tensor, kernel: np.ndarray = ELLIPSE_7) -> torch.Tensor:
    """Binary dilation of a {0,1} float mask (any leading dims)."""
    return (_conv2d_same(mask.float(), kernel, 0.0) > 0.5).to(mask.dtype)


def erode(mask: torch.Tensor, kernel: np.ndarray = ELLIPSE_7) -> torch.Tensor:
    """Binary erosion; outside the image counts as foreground (cv2)."""
    ksum = float(kernel.sum())
    return (_conv2d_same(mask.float(), kernel, 1.0) > ksum - 0.5).to(mask.dtype)


def close(mask: torch.Tensor, kernel: np.ndarray = ELLIPSE_5) -> torch.Tensor:
    return erode(dilate(mask, kernel), kernel)


def gaussian_blur5(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(x, (5, 5), 0): separable, REFLECT_101 border."""
    shape = x.shape
    x2 = x.reshape(-1, 1, shape[-2], shape[-1]).float()
    x2 = F.pad(x2, (2, 2, 2, 2), mode='reflect')
    g = torch.from_numpy(GAUSS_5).to(x.device)
    y = F.conv2d(x2, g.reshape(1, 1, 5, 1))
    y = F.conv2d(y, g.reshape(1, 1, 1, 5))
    return y.reshape(shape)
