"""Model registry: ``create_model(arch, encoder, classes)``.

Ported so far: Unet and UnetPlusPlus over the resnet encoders. Other pairs
raise NotImplementedError naming the ROADMAP item that adds them.
"""

from __future__ import annotations

from octseg_torch.models.base import SegmentationModel
from octseg_torch.models.decoders.unet import UnetDecoder, UnetPlusPlusDecoder
from octseg_torch.models.encoders.resnet import RESNETS, ResNetEncoder

_DECODERS = {'unet': UnetDecoder, 'unetplusplus': UnetPlusPlusDecoder}


def normalize_arch(arch: str) -> str:
    """Architecture spelling as octseg.models.normalize_arch keys it."""
    return arch.lower().replace('_', '').replace('-', '').replace('++', 'plusplus')


def create_model(arch: str, encoder_name: str, classes: int = 1) -> SegmentationModel:
    key = normalize_arch(arch)
    if key not in _DECODERS or encoder_name not in RESNETS:
        raise NotImplementedError(
            f'{arch}/{encoder_name} is not ported yet: octseg_torch has '
            f'Unet and UnetPlusPlus over resnet18/34/50/101/152. LinkNet, '
            f'efficientnet-b7 and timm-regnetx_064 are ROADMAP.md "The other two '
            f'winning models, then the full hybrid ensemble"; the other decoders '
            f'and encoders are "The rest of the model zoo".')
    encoder = ResNetEncoder(encoder_name)
    decoder = _DECODERS[key](encoder.out_channels)
    return SegmentationModel(encoder, decoder, head_in=16, classes=classes)
