"""Model registry: ``create_model(arch, encoder, classes)``.

Ported so far: the Unet, UnetPlusPlus and LinkNet decoders over every
resnet, efficientnet and timm-regnet encoder at output stride 32. The other
six decoders of octseg raise NotImplementedError naming the ROADMAP item
that adds them; an architecture octseg does not know raises ValueError, as
octseg's ``normalize_arch`` does.
"""

from __future__ import annotations

from octseg_torch.models.base import SegmentationModel
from octseg_torch.models.decoders.linknet import LinkNetDecoder
from octseg_torch.models.decoders.unet import UnetDecoder, UnetPlusPlusDecoder
from octseg_torch.models.encoders import SUPPORTED_ENCODERS, create_encoder

# arch key -> (decoder class, head input width, head kernel): SMP's
# SegmentationHead kernel is 3 for Unet/UNet++ and 1 for Linknet
_ARCHS = {
    'unet': (UnetDecoder, 16, 3),
    'unetplusplus': (UnetPlusPlusDecoder, 16, 3),
    'linknet': (LinkNetDecoder, 32, 1),
}

# octseg's SUPPORTED_ARCHITECTURES
SUPPORTED_ARCHITECTURES = ['Unet', 'UnetPlusPlus', 'LinkNet', 'FPN', 'PSPNet', 'PAN', 'MAnet',
                           'DeepLabV3', 'DeepLabV3Plus']


def normalize_arch(arch: str) -> str:
    """Architecture spelling as octseg.models.normalize_arch keys it."""
    key = arch.lower().replace('_', '').replace('-', '').replace('++', 'plusplus')
    if key not in {a.lower() for a in SUPPORTED_ARCHITECTURES}:
        raise ValueError(f'Unknown architecture {arch!r}; supported: {SUPPORTED_ARCHITECTURES}')
    return key


def create_model(arch: str, encoder_name: str, classes: int = 1) -> SegmentationModel:
    key = normalize_arch(arch)
    if key not in _ARCHS:
        raise NotImplementedError(
            f'{arch} is not ported yet: octseg_torch has the Unet, UnetPlusPlus and LinkNet '
            f'decoders; FPN, PSPNet, PAN, MAnet, DeepLabV3 and DeepLabV3Plus (and the '
            f'dilated encoders at output stride 8 and 16 that PAN and DeepLab need) are '
            f'ROADMAP.md "The rest of the model zoo"')
    decoder_cls, head_in, head_kernel = _ARCHS[key]
    encoder = create_encoder(encoder_name)
    return SegmentationModel(encoder, decoder_cls(encoder.out_channels), head_in=head_in,
                             classes=classes, head_kernel=head_kernel)


__all__ = ['create_model', 'normalize_arch', 'SUPPORTED_ARCHITECTURES', 'SUPPORTED_ENCODERS',
           'SegmentationModel']
