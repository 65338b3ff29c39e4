"""Model registry: ``create_model(arch, encoder, classes, dtype, remat)``.

All nine decoders of octseg (Unet, UnetPlusPlus, LinkNet, FPN, PSPNet,
PAN, MAnet, DeepLabV3, DeepLabV3Plus) over every resnet, efficientnet and
timm-regnet encoder, each at the encoder output stride its architecture
needs; an architecture octseg does not know raises ValueError, as octseg's
``normalize_arch`` does.
"""

from __future__ import annotations

import torch

from octseg_torch.models.base import SegmentationModel
from octseg_torch.models.common import set_compute_dtype
from octseg_torch.models.decoders.deeplab import DeepLabV3Decoder, DeepLabV3PlusDecoder
from octseg_torch.models.decoders.fpn import FPNDecoder
from octseg_torch.models.decoders.linknet import LinkNetDecoder
from octseg_torch.models.decoders.manet import MAnetDecoder
from octseg_torch.models.decoders.pan import PANDecoder
from octseg_torch.models.decoders.pspnet import PSPDecoder
from octseg_torch.models.decoders.unet import UnetDecoder, UnetPlusPlusDecoder
from octseg_torch.models.encoders import SUPPORTED_ENCODERS, create_encoder
from octseg_torch.models.remat import set_block_remat

# arch key -> (decoder class, encoder output stride, head input width, head
# kernel, head upsampling), octseg's _ARCHS: SMP's SegmentationHead kernel
# is 3 for Unet/UNet++/MAnet/PSPNet/PAN and 1 for Linknet/FPN/DeepLab, and it
# upsamples what the decoder leaves below full resolution
_ARCHS = {
    'unet': (UnetDecoder, 32, 16, 3, 1),
    'unetplusplus': (UnetPlusPlusDecoder, 32, 16, 3, 1),
    'linknet': (LinkNetDecoder, 32, 32, 1, 1),
    'fpn': (FPNDecoder, 32, 128, 1, 4),
    'pspnet': (PSPDecoder, 32, 512, 3, 8),
    'pan': (PANDecoder, 16, 32, 3, 4),
    'manet': (MAnetDecoder, 32, 16, 3, 1),
    'deeplabv3': (DeepLabV3Decoder, 8, 256, 1, 8),
    'deeplabv3plus': (DeepLabV3PlusDecoder, 16, 256, 1, 4),
}

# octseg's SUPPORTED_ARCHITECTURES
SUPPORTED_ARCHITECTURES = ['Unet', 'UnetPlusPlus', 'LinkNet', 'FPN', 'PSPNet', 'PAN', 'MAnet',
                           'DeepLabV3', 'DeepLabV3Plus']


def normalize_arch(arch: str) -> str:
    """Architecture spelling as octseg.models.normalize_arch keys it."""
    key = arch.lower().replace('_', '').replace('-', '').replace('++', 'plusplus')
    if key not in _ARCHS:
        raise ValueError(f'Unknown architecture {arch!r}; supported: {SUPPORTED_ARCHITECTURES}')
    return key


def create_model(arch: str, encoder_name: str, classes: int = 1,
                 dtype: torch.dtype = torch.float32, remat: bool = False) -> SegmentationModel:
    """A model with float32 parameters that computes its convolutions in
    ``dtype`` (octseg's ``dtype``: bfloat16 for mixed precision; logits are
    float32 either way, models/common.py) and, with ``remat``, checkpoints
    its blocks in training (models/remat.py)."""
    decoder_cls, output_stride, head_in, head_kernel, upsampling = _ARCHS[normalize_arch(arch)]
    encoder = create_encoder(encoder_name, output_stride)
    model = SegmentationModel(encoder, decoder_cls(encoder.out_channels), head_in=head_in,
                              classes=classes, head_kernel=head_kernel, upsampling=upsampling)
    return set_block_remat(set_compute_dtype(model, dtype), remat)


__all__ = ['create_model', 'normalize_arch', 'SUPPORTED_ARCHITECTURES', 'SUPPORTED_ENCODERS',
           'SegmentationModel']
