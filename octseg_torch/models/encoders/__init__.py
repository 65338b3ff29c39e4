"""Encoder registry: the family of an SMP encoder name, its module and its
pyramid widths (the port of octseg/models/encoders/__init__.py).

Every variant of the three families is ported at output stride 32; the
dilated encoders (output stride 8 or 16, for PAN and DeepLab) raise.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from octseg_torch.models.encoders.efficientnet import (
    _SCALING as EFFICIENTNETS, EfficientNetEncoder, efficientnet_out_channels)
from octseg_torch.models.encoders.regnet import (
    _CONFIGS as REGNETS, RegNetEncoder, regnet_out_channels)
from octseg_torch.models.encoders.resnet import RESNETS, ResNetEncoder, resnet_out_channels

# family -> (variants, encoder class, pyramid widths)
_FAMILIES = {
    'resnet': (RESNETS, ResNetEncoder, resnet_out_channels),
    'timm-regnet': (REGNETS, RegNetEncoder, regnet_out_channels),
    'efficientnet': (EFFICIENTNETS, EfficientNetEncoder, efficientnet_out_channels),
}

SUPPORTED_ENCODERS = [name for variants, _, _ in _FAMILIES.values() for name in variants]


def encoder_family(encoder_name: str) -> str:
    for family, (variants, _, _) in _FAMILIES.items():
        if encoder_name in variants:
            return family
    raise ValueError(f'Unknown encoder {encoder_name!r}; supported: {SUPPORTED_ENCODERS}')


def create_encoder(encoder_name: str, output_stride: int = 32) -> nn.Module:
    family = encoder_family(encoder_name)
    if output_stride != 32:
        raise NotImplementedError(
            f'{encoder_name} at output stride {output_stride} is not ported yet: the dilated '
            f'encoders are ROADMAP.md "The rest of the model zoo"')
    return _FAMILIES[family][1](encoder_name)


def encoder_out_channels(encoder_name: str) -> Sequence[int]:
    return _FAMILIES[encoder_family(encoder_name)][2](encoder_name)
