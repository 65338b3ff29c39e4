"""Weights bridge between the JAX package's flax tree and the port's
``state_dict``.

The inverse of octseg/models/convert_torch.py for the ported pieces: the
resnet, timm-regnet and efficientnet encoders (``_convert_resnet``,
``_convert_regnet``, ``_convert_efficientnet``), the Unet, UNet++ and LinkNet
decoders and the segmentation head. Port module names are SMP's, so
``state_dict_to_variables`` computes what ``convert_checkpoint`` computes,
and ``variables_to_state_dict`` undoes it:

- conv weight OIHW (torch) <-> kernel HWIO (flax); a transposed conv's
  weight (I, O, H, W) <-> its ``transpose_kernel=True`` kernel (H, W, O, I):
  the same axis permutation;
- a conv bias, where the torch conv has one, <-> ``bias``;
- BatchNorm ``weight/bias/running_mean/running_var`` <-> ``scale/bias``
  (params) and ``mean/var`` (batch_stats).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np

from octseg_torch.models import normalize_arch
from octseg_torch.models.encoders import encoder_family
from octseg_torch.models.encoders.efficientnet import flattened_blocks
from octseg_torch.models.encoders.regnet import _CONFIGS as REGNETS
from octseg_torch.models.encoders.resnet import RESNETS, Bottleneck

# (kind, torch module prefix, flax path): kind 'conv' (weight), 'conv+bias'
# (weight and bias) or 'bn'
_Entry = Tuple[str, str, str]


def _conv_bn(tconv: str, tbn: str, f: str) -> Iterator[_Entry]:
    yield 'conv', tconv, f'{f}/Conv_0'
    yield 'bn', tbn, f'{f}/BatchNorm_0'


def _resnet(variant: str) -> Iterator[_Entry]:
    block, layers = RESNETS[variant]
    name, nconv = ('Bottleneck', 3) if block is Bottleneck else ('BasicBlock', 2)
    yield from _conv_bn('encoder.conv1', 'encoder.bn1', 'encoder/ConvBNAct_0')
    k = 0
    inplanes = 64
    for stage, (n_blocks, width) in enumerate(zip(layers, (64, 128, 256, 512)), 1):
        for b in range(n_blocks):
            t, f = f'encoder.layer{stage}.{b}', f'encoder/{name}_{k}'
            for i in range(nconv):
                yield from _conv_bn(f'{t}.conv{i + 1}', f'{t}.bn{i + 1}', f'{f}/ConvBNAct_{i}')
            stride = 2 if (b == 0 and stage > 1) else 1
            if b == 0 and (stride != 1 or inplanes != width * block.expansion):
                yield from _conv_bn(f'{t}.downsample.0', f'{t}.downsample.1',
                                    f'{f}/ConvBNAct_{nconv}')
            inplanes = width * block.expansion
            k += 1


def _regnet(variant: str) -> Iterator[_Entry]:
    cfg = REGNETS[variant]
    yield from _conv_bn('encoder.stem.conv', 'encoder.stem.bn', 'encoder/ConvBNAct_0')
    n = 0
    for stage, depth in enumerate(cfg['depths'], start=1):
        for j in range(1, depth + 1):
            t, f = f'encoder.s{stage}.b{j}', f'encoder/RegNetBlock_{n}'
            for i in range(3):
                yield from _conv_bn(f'{t}.conv{i + 1}.conv', f'{t}.conv{i + 1}.bn',
                                    f'{f}/ConvBNAct_{i}')
            if cfg['se']:
                yield 'conv+bias', f'{t}.se.fc1', f'{f}/SqueezeExcite_0/Conv_0'
                yield 'conv+bias', f'{t}.se.fc2', f'{f}/SqueezeExcite_0/Conv_1'
            if j == 1:   # every stage's first block strides, so it downsamples
                yield from _conv_bn(f'{t}.downsample.conv', f'{t}.downsample.bn',
                                    f'{f}/ConvBNAct_3')
            n += 1


def _efficientnet(variant: str) -> Iterator[_Entry]:
    yield from _conv_bn('encoder._conv_stem', 'encoder._bn0', 'encoder/ConvBNAct_0')
    for i, blk in enumerate(flattened_blocks(variant)):
        t, f = f'encoder._blocks.{i}', f'encoder/MBConv_{i}'
        idx = 0
        if blk['expand'] != 1:
            yield from _conv_bn(f'{t}._expand_conv', f'{t}._bn0', f'{f}/ConvBNAct_0')
            idx = 1
        yield from _conv_bn(f'{t}._depthwise_conv', f'{t}._bn1', f'{f}/ConvBNAct_{idx}')
        yield 'conv+bias', f'{t}._se_reduce', f'{f}/SqueezeExcite_0/Conv_0'
        yield 'conv+bias', f'{t}._se_expand', f'{f}/SqueezeExcite_0/Conv_1'
        yield from _conv_bn(f'{t}._project_conv', f'{t}._bn2', f'{f}/ConvBNAct_{idx + 1}')


def _unet() -> Iterator[_Entry]:
    for i in range(5):
        for c in range(2):
            yield from _conv_bn(f'decoder.blocks.{i}.conv{c + 1}.0',
                                f'decoder.blocks.{i}.conv{c + 1}.1',
                                f'decoder/DecoderBlock_{i}/ConvBNAct_{c}')


def _unetpp() -> Iterator[_Entry]:
    # flax creates grid nodes column by column (j outer, i inner), then x_0_4
    nodes = [f'x_{4 - i - j}_{3 - i}' for j in range(1, 5) for i in range(0, 5 - j)]
    for m, name in enumerate(nodes + ['x_0_4']):
        for c in range(2):
            yield from _conv_bn(f'decoder.blocks.{name}.conv{c + 1}.0',
                                f'decoder.blocks.{name}.conv{c + 1}.1',
                                f'decoder/ConvBNAct_{2 * m + c}')


def _linknet() -> Iterator[_Entry]:
    for i in range(5):
        t, f = f'decoder.blocks.{i}.block', f'decoder/LinkNetDecoderBlock_{i}'
        yield from _conv_bn(f'{t}.0.0', f'{t}.0.1', f'{f}/ConvBNAct_0')
        yield 'conv', f'{t}.1.0', f'{f}/ConvTranspose_0'
        yield 'bn', f'{t}.1.1', f'{f}/BatchNorm_0'
        yield from _conv_bn(f'{t}.2.0', f'{t}.2.1', f'{f}/ConvBNAct_1')


_ENCODERS = {'resnet': _resnet, 'timm-regnet': _regnet, 'efficientnet': _efficientnet}
_DECODERS = {'unet': _unet, 'unetplusplus': _unetpp, 'linknet': _linknet}


def _entries(architecture: str, encoder: str) -> Iterator[_Entry]:
    key = normalize_arch(architecture)
    if key not in _DECODERS:
        raise NotImplementedError(
            f'no weights bridge for the {architecture} decoder yet: ROADMAP.md "The rest of '
            f'the model zoo"')
    yield from _ENCODERS[encoder_family(encoder)](encoder)
    yield from _DECODERS[key]()
    yield 'conv+bias', 'segmentation_head.0', 'head/Conv_0'


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
    for kind, t, f in _entries(architecture, encoder):
        if kind == 'bn':
            sd[f'{t}.weight'] = np.asarray(_get(params, f'{f}/scale'))
            sd[f'{t}.bias'] = np.asarray(_get(params, f'{f}/bias'))
            sd[f'{t}.running_mean'] = np.asarray(_get(stats, f'{f}/mean'))
            sd[f'{t}.running_var'] = np.asarray(_get(stats, f'{f}/var'))
            sd[f'{t}.num_batches_tracked'] = np.zeros((), np.int64)
            continue
        sd[f'{t}.weight'] = np.ascontiguousarray(
            np.asarray(_get(params, f'{f}/kernel')).transpose(3, 2, 0, 1))
        if kind == 'conv+bias':
            sd[f'{t}.bias'] = np.asarray(_get(params, f'{f}/bias'))
    return sd


def state_dict_to_variables(sd: Dict[str, np.ndarray], architecture: str,
                            encoder: str) -> Dict[str, Any]:
    """The port's state_dict (numpy values) -> flax ``{'params',
    'batch_stats'}``, as octseg.models.convert_torch.convert_checkpoint
    builds it."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for kind, t, f in _entries(architecture, encoder):
        if kind == 'bn':
            _put(params, f'{f}/scale', np.asarray(sd[f'{t}.weight']))
            _put(params, f'{f}/bias', np.asarray(sd[f'{t}.bias']))
            _put(stats, f'{f}/mean', np.asarray(sd[f'{t}.running_mean']))
            _put(stats, f'{f}/var', np.asarray(sd[f'{t}.running_var']))
            continue
        _put(params, f'{f}/kernel', np.ascontiguousarray(
            np.asarray(sd[f'{t}.weight']).transpose(2, 3, 1, 0)))
        if kind == 'conv+bias':
            _put(params, f'{f}/bias', np.asarray(sd[f'{t}.bias']))
    return {'params': params, 'batch_stats': stats}
