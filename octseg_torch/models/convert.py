"""Weights bridge between the JAX package's flax tree and the port's
``state_dict``.

The inverse of octseg/models/convert_torch.py: the resnet, timm-regnet and
efficientnet encoders (``_convert_resnet``, ``_convert_regnet``,
``_convert_efficientnet``; their dilated variants have the same names), the
nine decoders (``_convert_{unet,unetpp,linknet,fpn,psp,pan,manet,
deeplabv3,deeplabv3plus}_decoder``) and the segmentation head. Port module
names are SMP's, so
``state_dict_to_variables`` computes what ``convert_checkpoint`` computes,
and ``variables_to_state_dict`` undoes it:

- conv weight OIHW (torch) <-> kernel HWIO (flax); a transposed conv's
  weight (I, O, H, W) <-> its ``transpose_kernel=True`` kernel (H, W, O, I):
  the same axis permutation;
- a conv bias, where the torch conv has one, <-> ``bias``;
- BatchNorm ``weight/bias/running_mean/running_var`` <-> ``scale/bias``
  (params) and ``mean/var`` (batch_stats);
- GroupNorm ``weight/bias`` <-> ``scale/bias`` (params).
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
# (weight and bias), 'bn' or 'gn'
_Entry = Tuple[str, str, str]


def _conv_bn(tconv: str, tbn: str, f: str, bias: bool = False) -> Iterator[_Entry]:
    yield 'conv+bias' if bias else 'conv', tconv, f'{f}/Conv_0'
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


def _fpn() -> Iterator[_Entry]:
    yield 'conv+bias', 'decoder.p5', 'decoder/p5'
    for lvl in (4, 3, 2):
        yield 'conv+bias', f'decoder.p{lvl}.skip_conv', f'decoder/p{lvl}_skip'
    for i, n_up in enumerate((3, 2, 1, 0)):
        for j in range(max(n_up, 1)):
            t, f = f'decoder.seg_blocks.{i}.block.{j}.block', f'decoder/seg_{i}_{j}'
            yield 'conv', f'{t}.0', f'{f}/Conv_0'
            yield 'gn', f'{t}.1', f'{f}/GroupNorm_0'


def _psp() -> Iterator[_Entry]:
    for i in range(4):
        t, f = f'decoder.psp.blocks.{i}.pool.1', f'decoder/psp_{i}'
        if i == 0:   # the 1-bin branch: no BatchNorm, a conv bias
            yield 'conv+bias', f'{t}.0', f'{f}/Conv_0'
        else:
            yield from _conv_bn(f'{t}.0', f'{t}.1', f)
    yield from _conv_bn('decoder.conv.0', 'decoder.conv.1', 'decoder/conv')


# (torch ConvBnRelu path, flax module name) inside the PAN FPA block
_PAN_FPA = [('branch1.1', 'branch1'), ('mid.0', 'mid'), ('down1.1', 'down1'),
            ('down2.1', 'down2'), ('down3.1', 'down3_0'), ('down3.2', 'down3_1'),
            ('conv2', 'conv2'), ('conv1', 'conv1')]


def _pan() -> Iterator[_Entry]:
    for t, f in _PAN_FPA:
        yield from _conv_bn(f'decoder.fpa.{t}.conv', f'decoder.fpa.{t}.bn', f'decoder/fpa/{f}',
                            bias=True)
    for g in (3, 2, 1):
        t, f = f'decoder.gau{g}', f'decoder/gau{g}'
        yield from _conv_bn(f'{t}.conv1.1.conv', f'{t}.conv1.1.bn', f'{f}/conv1', bias=True)
        yield from _conv_bn(f'{t}.conv2.conv', f'{t}.conv2.bn', f'{f}/conv2', bias=True)


def _manet() -> Iterator[_Entry]:
    for t, f in (('top_conv', 'top'), ('center_conv', 'center'), ('bottom_conv', 'bottom'),
                 ('out_conv', 'out')):
        yield 'conv+bias', f'decoder.center.{t}', f'decoder/center/{f}'
    for i in range(4):
        t, f = f'decoder.blocks.{i}', f'decoder/block{i}'
        for c in range(2):
            yield from _conv_bn(f'{t}.hl_conv.{c}.0', f'{t}.hl_conv.{c}.1', f'{f}/hl_conv_{c}')
        for se in ('hl', 'll'):
            yield 'conv+bias', f'{t}.SE_{se}.1', f'{f}/se_{se}_fc1'
            yield 'conv+bias', f'{t}.SE_{se}.3', f'{f}/se_{se}_fc2'
        for c in (1, 2):
            yield from _conv_bn(f'{t}.conv{c}.0', f'{t}.conv{c}.1', f'{f}/conv{c}')
    for c in (1, 2):
        yield from _conv_bn(f'decoder.blocks.4.conv{c}.0', f'decoder.blocks.4.conv{c}.1',
                            f'decoder/block4/conv{c}')


def _separable(t: str, tbn: str, f: str) -> Iterator[_Entry]:
    """SeparableConv2d ``t`` (``.0`` depthwise, ``.1`` pointwise) and its
    BatchNorm ``tbn`` -> octseg's SeparableConvBNAct ``f`` (``dw``, ``pw``)."""
    yield 'conv', f'{t}.0', f'{f}/dw'
    yield from _conv_bn(f'{t}.1', tbn, f'{f}/pw')


def _aspp(t: str, f: str, separable: bool) -> Iterator[_Entry]:
    yield from _conv_bn(f'{t}.convs.0.0', f'{t}.convs.0.1', f'{f}/convs0')
    for i in (1, 2, 3):
        if separable:
            yield from _separable(f'{t}.convs.{i}.0', f'{t}.convs.{i}.1', f'{f}/convs{i}')
        else:
            yield from _conv_bn(f'{t}.convs.{i}.0', f'{t}.convs.{i}.1', f'{f}/convs{i}')
    yield from _conv_bn(f'{t}.convs.4.1', f'{t}.convs.4.2', f'{f}/convs4')
    yield from _conv_bn(f'{t}.project.0', f'{t}.project.1', f'{f}/project')


def _deeplabv3() -> Iterator[_Entry]:
    yield from _aspp('decoder.0', 'decoder/aspp', separable=False)
    yield from _conv_bn('decoder.1', 'decoder.2', 'decoder/conv')


def _deeplabv3plus() -> Iterator[_Entry]:
    yield from _aspp('decoder.aspp.0', 'decoder/aspp', separable=True)
    yield from _separable('decoder.aspp.1', 'decoder.aspp.2', 'decoder/aspp_sep')
    yield from _conv_bn('decoder.block1.0', 'decoder.block1.1', 'decoder/block1')
    yield from _separable('decoder.block2.0', 'decoder.block2.1', 'decoder/block2')


_ENCODERS = {'resnet': _resnet, 'timm-regnet': _regnet, 'efficientnet': _efficientnet}
_DECODERS = {'unet': _unet, 'unetplusplus': _unetpp, 'linknet': _linknet, 'fpn': _fpn,
             'pspnet': _psp, 'pan': _pan, 'manet': _manet, 'deeplabv3': _deeplabv3,
             'deeplabv3plus': _deeplabv3plus}


def _entries(architecture: str, encoder: str) -> Iterator[_Entry]:
    yield from _ENCODERS[encoder_family(encoder)](encoder)
    yield from _DECODERS[normalize_arch(architecture)]()
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
        if kind == 'gn':
            sd[f'{t}.weight'] = np.asarray(_get(params, f'{f}/scale'))
            sd[f'{t}.bias'] = np.asarray(_get(params, f'{f}/bias'))
            continue
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
        if kind == 'gn':
            _put(params, f'{f}/scale', np.asarray(sd[f'{t}.weight']))
            _put(params, f'{f}/bias', np.asarray(sd[f'{t}.bias']))
            continue
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
