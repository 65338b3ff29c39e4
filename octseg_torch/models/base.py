"""SegmentationModel: encoder -> decoder -> segmentation head.

The port of octseg/models/base.py. NCHW in, NCHW multilabel logits out, one
channel per class in the order of the model's ``classes``. The head is SMP's
``segmentation_head.0`` conv (with bias, kernel 3 or 1), then, for a decoder
that ends below full resolution, SMP's ``UpsamplingBilinear2d`` by
``upsampling`` (4 for FPN, PAN and DeepLabV3Plus, 8 for PSPNet and
DeepLabV3): bilinear with ``align_corners=True`` through octseg's
interpolation matrices.
"""

from __future__ import annotations

import torch
from torch import nn

from octseg_torch.models.common import Conv2d, resize_bilinear_torch


class SegmentationModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, head_in: int,
                 classes: int, head_kernel: int = 3, upsampling: int = 1):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.segmentation_head = nn.Sequential(
            Conv2d(head_in, classes, head_kernel, padding=head_kernel // 2))
        self.upsampling = upsampling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.segmentation_head(self.decoder(self.encoder(x)))
        if self.upsampling > 1:
            h, w = y.shape[-2:]
            y = resize_bilinear_torch(y, (h * self.upsampling, w * self.upsampling),
                                      align_corners=True)
        # logits in float32 whatever the compute dtype, as octseg's head
        return y.float()
