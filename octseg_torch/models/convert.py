"""Weights bridge between the JAX package's flax tree and the port's
``state_dict``.

The inverse of octseg/models/convert_torch.py for the ported pieces: the
resnet encoders (``_convert_resnet``), the Unet and UNet++ decoders and the
segmentation head. Port module names are SMP's, so ``state_dict_to_variables``
computes what ``convert_checkpoint`` computes, and ``variables_to_state_dict``
undoes it:

- conv kernel HWIO (flax) <-> weight OIHW (torch);
- BatchNorm ``scale/bias`` (params) + ``mean/var`` (batch_stats) <->
  ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np

from octseg_torch.models import normalize_arch
from octseg_torch.models.encoders.resnet import RESNETS, Bottleneck

# (torch conv prefix, torch bn prefix, flax ConvBNAct path)
_Pair = Tuple[str, str, str]


def _resnet_pairs(variant: str) -> Iterator[_Pair]:
    block, layers = RESNETS[variant]
    name, nconv = ('Bottleneck', 3) if block is Bottleneck else ('BasicBlock', 2)
    yield 'encoder.conv1', 'encoder.bn1', 'encoder/ConvBNAct_0'
    k = 0
    inplanes = 64
    for stage, (n_blocks, width) in enumerate(zip(layers, (64, 128, 256, 512)), 1):
        for b in range(n_blocks):
            t, f = f'encoder.layer{stage}.{b}', f'encoder/{name}_{k}'
            for i in range(nconv):
                yield f'{t}.conv{i + 1}', f'{t}.bn{i + 1}', f'{f}/ConvBNAct_{i}'
            stride = 2 if (b == 0 and stage > 1) else 1
            if b == 0 and (stride != 1 or inplanes != width * block.expansion):
                yield f'{t}.downsample.0', f'{t}.downsample.1', f'{f}/ConvBNAct_{nconv}'
            inplanes = width * block.expansion
            k += 1


def _unet_pairs() -> Iterator[_Pair]:
    for i in range(5):
        for c in range(2):
            yield (f'decoder.blocks.{i}.conv{c + 1}.0', f'decoder.blocks.{i}.conv{c + 1}.1',
                   f'decoder/DecoderBlock_{i}/ConvBNAct_{c}')


def _unetpp_pairs() -> Iterator[_Pair]:
    # flax creates grid nodes column by column (j outer, i inner), then x_0_4
    nodes = [f'x_{4 - i - j}_{3 - i}' for j in range(1, 5) for i in range(0, 5 - j)]
    for m, name in enumerate(nodes + ['x_0_4']):
        for c in range(2):
            yield (f'decoder.blocks.{name}.conv{c + 1}.0', f'decoder.blocks.{name}.conv{c + 1}.1',
                   f'decoder/ConvBNAct_{2 * m + c}')


_DECODER_PAIRS = {'unet': _unet_pairs, 'unetplusplus': _unetpp_pairs}
_HEAD = ('segmentation_head.0', 'head/Conv_0')


def _pairs(architecture: str, encoder: str) -> Iterator[_Pair]:
    key = normalize_arch(architecture)
    if key not in _DECODER_PAIRS or encoder not in RESNETS:
        raise NotImplementedError(f'no weights bridge for {architecture}/{encoder}')
    yield from _resnet_pairs(encoder)
    yield from _DECODER_PAIRS[key]()


def _get(tree: Dict[str, Any], path: str) -> Any:
    for part in path.split('/'):
        tree = tree[part]
    return tree


def _put(tree: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split('/')
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def variables_to_state_dict(variables: Dict[str, Any], architecture: str,
                            encoder: str) -> Dict[str, np.ndarray]:
    """flax ``{'params', 'batch_stats'}`` (numpy leaves) -> the port's
    state_dict as numpy arrays (``num_batches_tracked`` = 0)."""
    params, stats = variables['params'], variables['batch_stats']
    sd: Dict[str, np.ndarray] = {}
    for tconv, tbn, f in _pairs(architecture, encoder):
        sd[f'{tconv}.weight'] = np.ascontiguousarray(
            np.asarray(_get(params, f'{f}/Conv_0/kernel')).transpose(3, 2, 0, 1))
        sd[f'{tbn}.weight'] = np.asarray(_get(params, f'{f}/BatchNorm_0/scale'))
        sd[f'{tbn}.bias'] = np.asarray(_get(params, f'{f}/BatchNorm_0/bias'))
        sd[f'{tbn}.running_mean'] = np.asarray(_get(stats, f'{f}/BatchNorm_0/mean'))
        sd[f'{tbn}.running_var'] = np.asarray(_get(stats, f'{f}/BatchNorm_0/var'))
        sd[f'{tbn}.num_batches_tracked'] = np.zeros((), np.int64)
    thead, fhead = _HEAD
    sd[f'{thead}.weight'] = np.ascontiguousarray(
        np.asarray(_get(params, f'{fhead}/kernel')).transpose(3, 2, 0, 1))
    sd[f'{thead}.bias'] = np.asarray(_get(params, f'{fhead}/bias'))
    return sd


def state_dict_to_variables(sd: Dict[str, np.ndarray], architecture: str,
                            encoder: str) -> Dict[str, Any]:
    """The port's state_dict (numpy values) -> flax ``{'params',
    'batch_stats'}``, as octseg.models.convert_torch.convert_checkpoint
    builds it."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for tconv, tbn, f in _pairs(architecture, encoder):
        _put(params, f'{f}/Conv_0/kernel', np.ascontiguousarray(
            np.asarray(sd[f'{tconv}.weight']).transpose(2, 3, 1, 0)))
        _put(params, f'{f}/BatchNorm_0/scale', np.asarray(sd[f'{tbn}.weight']))
        _put(params, f'{f}/BatchNorm_0/bias', np.asarray(sd[f'{tbn}.bias']))
        _put(stats, f'{f}/BatchNorm_0/mean', np.asarray(sd[f'{tbn}.running_mean']))
        _put(stats, f'{f}/BatchNorm_0/var', np.asarray(sd[f'{tbn}.running_var']))
    thead, fhead = _HEAD
    _put(params, f'{fhead}/kernel', np.ascontiguousarray(
        np.asarray(sd[f'{thead}.weight']).transpose(2, 3, 1, 0)))
    _put(params, f'{fhead}/bias', np.asarray(sd[f'{thead}.bias']))
    return {'params': params, 'batch_stats': stats}
