"""Input normalization and logits thresholding (octseg/ops/normalize.py).

sigmoid(x) > 0.5 is x > 0, so the default threshold needs no
transcendental.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(x: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD,
                       input_scale: float = 1.0, channel_dim: int = -1) -> torch.Tensor:
    """(x * input_scale - mean) / std over ``channel_dim`` (last by default,
    the JAX package's NHWC layout)."""
    shape = [1] * x.ndim
    shape[channel_dim] = len(mean)
    mean_t = torch.tensor(mean, dtype=x.dtype, device=x.device).reshape(shape)
    std_t = torch.tensor(std, dtype=x.dtype, device=x.device).reshape(shape)
    return (x * input_scale - mean_t) / std_t


def sigmoid_threshold(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Binary float mask, == sigmoid(logits) > threshold."""
    if threshold == 0.5:
        return (logits > 0).to(torch.float32)
    return (logits > math.log(threshold / (1.0 - threshold))).to(torch.float32)
