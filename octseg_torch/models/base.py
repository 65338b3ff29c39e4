"""SegmentationModel: encoder -> decoder -> segmentation head.

The port of octseg/models/base.py. NCHW in, NCHW multilabel logits out, one
channel per class in the order of the model's ``classes``. The head is SMP's
``segmentation_head.0`` conv (with bias, kernel 3 or 1); Unet, UNet++ and
LinkNet end at full resolution, so it needs no upsampling.
"""

from __future__ import annotations

import torch
from torch import nn

from octseg_torch.models.common import Conv2d


class SegmentationModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, head_in: int,
                 classes: int, head_kernel: int = 3):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.segmentation_head = nn.Sequential(
            Conv2d(head_in, classes, head_kernel, padding=head_kernel // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # logits in float32 whatever the compute dtype, as octseg's head
        return self.segmentation_head(self.decoder(self.encoder(x))).float()
