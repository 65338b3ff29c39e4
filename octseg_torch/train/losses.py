"""Multilabel soft Dice loss from logits (the port of octseg/train/losses.py).

smp's ``DiceLoss(MULTILABEL_MODE, from_logits=True)`` as the reference uses
it: one soft dice per class over the whole batch (batch and pixels summed
jointly), smooth 0, eps 1e-7, loss = mean over classes of (1 - dice).
Logits and targets are NCHW here.
"""

from __future__ import annotations

import torch


def dice_loss_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                          smooth: float = 0.0, eps: float = 1e-7) -> torch.Tensor:
    """Scalar loss for (N, C, H, W) logits and {0,1} targets."""
    probs = torch.sigmoid(logits.float())
    targets = targets.float()
    intersection = torch.sum(probs * targets, dim=(0, 2, 3))
    cardinality = torch.sum(probs + targets, dim=(0, 2, 3))
    dice = (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth, min=eps)
    return torch.mean(1.0 - dice)
