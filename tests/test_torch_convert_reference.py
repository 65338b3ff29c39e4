"""The reference-checkpoint import of octseg_torch against the JAX package's.

Reference model dirs (``config.json`` + a torch ``weights.ckpt``) are built
here in three storage forms: a Lightning checkpoint as Lightning writes one
(``model.``-prefixed ``state_dict`` with SMP's ``mean``/``std`` buffers,
optimizer and scheduler states, callbacks, hyper-parameters, epoch and step),
a bare SMP state dict, and a bare one with ``mean``/``std``. Their weights
are SMP-named: from ``tests/torch_smp_mirror.py`` (Unet, UNet++ and LinkNet
over resnet18), or made by the port's ``variables_to_state_dict`` from seeded
variables of octseg's models (efficientnet-b0 and timm-regnetx_002 under the
winners' decoders, and DeepLabV3+ over a dilated efficientnet-b0).

Both converters run on every dir, octseg's once per file (a module fixture):
the port's ``weights.ckpt`` is byte-equal to octseg's and its
``config.json`` JSON-equal. The CLI, ``--input-size``, the errors, and the
logits of the converted models in each package's engine (to 2e-3) are held
as well.
"""

import json
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.infer.engine import load_model_bundle as jax_load_model_bundle
from octseg.models import create_model as jax_create_model
from octseg.models import convert_torch as jax_convert
from octseg_torch.infer.engine import load_model_bundle
from octseg_torch.models import convert_torch
from octseg_torch.models.convert import variables_to_state_dict
from tests.test_torch_models import _random_variables
from tests.torch_smp_mirror import SMPModel, randomize
from tests.torch_threads import torch_threads_share  # noqa: F401

SIZE = 64

# (name, architecture, encoder, classes, weights source, storage form)
CASES = [
    ('unet_r18', 'Unet', 'resnet18', ['Lumen'], 'mirror', 'lightning'),
    ('unetpp_r18', 'UnetPlusPlus', 'resnet18', ['Lumen'], 'mirror', 'bare'),
    ('linknet_r18', 'Linknet', 'resnet18', ['Lipid core', 'Fibrous cap'], 'mirror',
     'bare+buffers'),
    ('unetpp_b0', 'UnetPlusPlus', 'efficientnet-b0', ['Lumen'], 'octseg', 'lightning'),
    ('linknet_b0', 'LinkNet', 'efficientnet-b0', ['Lipid core', 'Fibrous cap'], 'octseg',
     'bare'),
    ('unet_b0', 'Unet', 'efficientnet-b0', ['Vasa vasorum'], 'octseg', 'bare+buffers'),
    ('unetpp_x002', 'UnetPlusPlus', 'timm-regnetx_002', ['Lumen'], 'octseg', 'bare+buffers'),
    ('linknet_x002', 'LinkNet', 'timm-regnetx_002', ['Lipid core', 'Fibrous cap'], 'octseg',
     'lightning'),
    ('unet_x002', 'Unet', 'timm-regnetx_002', ['Vasa vasorum'], 'octseg', 'bare'),
    ('deeplabv3plus_b0', 'DeepLabV3Plus', 'efficientnet-b0', ['Lumen'], 'octseg', 'lightning'),
]
NAMES = [c[0] for c in CASES]
_BY_NAME = {c[0]: c for c in CASES}


def _smp_state_dict(arch, encoder, n_classes, source, seed):
    """SMP-named weights as numpy arrays."""
    if source == 'mirror':
        tm = randomize(SMPModel(arch, encoder, n_classes), seed).eval()
        return {k: v.numpy() for k, v in tm.state_dict().items()}
    fm = jax_create_model(arch, encoder, classes=n_classes)
    variables = _random_variables(fm, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed)
    return variables_to_state_dict(jax.tree.map(np.asarray, variables), arch, encoder)


def _lightning(state_dict, n_classes):
    """A checkpoint dict as Lightning writes one, of plain types only."""
    first = next(iter(state_dict.values()))
    return {
        'epoch': 24, 'global_step': 2500, 'pytorch-lightning_version': '2.1.3',
        'state_dict': state_dict,
        'loops': {'fit_loop': {'state_dict': {}, 'epoch_progress': {
            'total': {'ready': 25, 'completed': 24}, 'current': {'ready': 25, 'completed': 24}}}},
        'callbacks': {"ModelCheckpoint{'monitor': 'val/f1', 'mode': 'max'}": {
            'monitor': 'val/f1', 'best_model_score': torch.tensor(0.93),
            'best_model_path': '/models/LM/weights.ckpt', 'current_score': torch.tensor(0.91),
            'dirpath': '/models/LM', 'best_k_models': {}, 'kth_best_model_path': '',
            'kth_value': torch.tensor(float('-inf')), 'last_model_path': ''}},
        'optimizer_states': [{
            'state': {0: {'step': torch.tensor(2500.0), 'exp_avg': torch.zeros_like(first),
                          'exp_avg_sq': torch.zeros_like(first)}},
            'param_groups': [{'lr': 1e-4, 'betas': (0.9, 0.999), 'eps': 1e-8,
                              'weight_decay': 0.0, 'amsgrad': False, 'maximize': False,
                              'foreach': None, 'capturable': False, 'differentiable': False,
                              'fused': None, 'initial_lr': 1e-4, 'params': [0]}]}],
        'lr_schedulers': [{'T_max': 25, 'eta_min': 1e-6, 'base_lrs': [1e-4], 'last_epoch': 24,
                           '_step_count': 25, 'verbose': False, '_get_lr_called_within_step':
                           False, '_last_lr': [1.4e-6]}],
        'hyper_parameters': {'arch': 'Unet', 'classes': n_classes, 'lr': 1e-4,
                             'optimizer_name': 'Adam', 'input_size': SIZE},
    }


def write_reference_dir(root, name, config_extra=None, drop_input_size=False, seed=None):
    """The reference model dir of case ``name`` under ``root``; returns its
    path and its state dict (numpy, SMP names)."""
    _n, arch, encoder, classes, source, form = _BY_NAME[name]
    seed = NAMES.index(name) if seed is None else seed
    sd = _smp_state_dict(arch, encoder, len(classes), source, seed)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    buffers = {'mean': torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1) * 255,
               'std': torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1) * 255}
    if form == 'lightning':
        payload = _lightning({**buffers, **{f'model.{k}': v for k, v in tensors.items()}},
                             len(classes))
    elif form == 'bare+buffers':
        payload = {**tensors, **buffers}
    else:
        payload = tensors
    path = os.path.join(root, f'torch_{name}')
    os.makedirs(path, exist_ok=True)
    torch.save(payload, os.path.join(path, 'weights.ckpt'))
    cfg = {'model_name': f'{arch}_{encoder}', 'architecture': arch, 'encoder': encoder,
           'input_size': SIZE, 'classes': classes, 'batch_size': 4, 'optimizer': 'Adam',
           'lr': 1e-4, **(config_extra or {})}
    if drop_input_size:
        del cfg['input_size']
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    return path, sd


def _octseg_convert(src, dst, **kw):
    """octseg's converter; its ``torch.load(weights_only=False)`` reads the
    same files."""
    return jax_convert.convert_reference_model_dir(src, dst, **kw)


@pytest.fixture(scope='module')
def converted(tmp_path_factory):
    """Every case written and converted by octseg once: name -> (reference
    dir, octseg's dir, state dict)."""
    root = str(tmp_path_factory.mktemp('reference'))
    out = {}
    for name in NAMES:
        src, sd = write_reference_dir(root, name)
        out[name] = (src, _octseg_convert(src, os.path.join(root, f'octseg_{name}')), sd)
    return out


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


@pytest.mark.parametrize('name', NAMES)
def test_converted_dir_is_byte_equal_to_octsegs(converted, tmp_path, name):
    src, want, _sd = converted[name]
    got = convert_torch.convert_reference_model_dir(src, str(tmp_path / 'port'))
    assert got == str(tmp_path / 'port')
    assert _read(os.path.join(got, 'weights.ckpt')) == _read(os.path.join(want, 'weights.ckpt'))
    with open(os.path.join(got, 'config.json')) as f, \
            open(os.path.join(want, 'config.json')) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize('name', ['unet_r18', 'unet_x002'])
def test_converted_logits_match_octsegs_engine(converted, tmp_path, name):
    src, want_dir, _sd = converted[name]
    got_dir = convert_torch.convert_reference_model_dir(src, str(tmp_path / 'port'))
    model, cfg = load_model_bundle(got_dir, torch.device('cpu'))
    jm, jv, jcfg = jax_load_model_bundle(want_dir)
    assert cfg == jcfg
    x = np.random.default_rng(3).normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jm.apply(jv, jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == want.shape == (2, len(cfg['classes']), SIZE, SIZE)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_cli_and_input_size_override_match_octsegs(converted, tmp_path, capsys):
    src, _want, _sd = converted['unet_x002']
    out = str(tmp_path / 'port32')
    convert_torch.main([src, out, '--input-size', '32'])
    assert capsys.readouterr().out.strip() == out
    jax_convert.main([src, str(tmp_path / 'octseg32'), '--input-size', '32'])
    for f in ('weights.ckpt', 'config.json'):
        assert _read(os.path.join(out, f)) == _read(str(tmp_path / 'octseg32' / f))
    with open(os.path.join(out, 'config.json')) as f:
        assert json.load(f)['input_size'] == 32


def test_no_input_size_raises_octsegs_value_error(tmp_path):
    src, _sd = write_reference_dir(str(tmp_path), 'unet_r18', drop_input_size=True)
    with pytest.raises(ValueError, match='has no input_size') as want:
        _octseg_convert(src, str(tmp_path / 'o'))
    with pytest.raises(ValueError, match='has no input_size') as got:
        convert_torch.convert_reference_model_dir(src, str(tmp_path / 'p'))
    assert str(got.value) == str(want.value)
    # --input-size supplies it, and is written into the manifest
    out = convert_torch.convert_reference_model_dir(src, str(tmp_path / 'p'), input_size=48)
    with open(os.path.join(out, 'config.json')) as f:
        assert json.load(f)['input_size'] == 48


def test_mismatched_and_missing_tensors_raise_value_error(tmp_path):
    # the manifest says two classes, the head has one: both packages refuse
    src, sd = write_reference_dir(str(tmp_path), 'unet_r18',
                                  config_extra={'classes': ['Lumen', 'Vasa vasorum']})
    with pytest.raises(ValueError, match='does not match the model'):
        _octseg_convert(src, str(tmp_path / 'o'))
    with pytest.raises(ValueError, match=r'shape mismatch at segmentation_head\.0\.weight'):
        convert_torch.convert_reference_model_dir(src, str(tmp_path / 'p'))
    assert not os.path.exists(tmp_path / 'p')
    # a tensor left out: the port lists it in a ValueError (octseg raises a
    # KeyError from its converter for the first one it misses)
    lm = sd.copy()
    del lm['decoder.blocks.0.conv1.0.weight'], lm['encoder.bn1.running_var']
    with pytest.raises(ValueError) as err:
        convert_torch.model_state_dict(lm, 'Unet', 'resnet18', 1)
    assert 'missing decoder.blocks.0.conv1.0.weight' in str(err.value)
    assert 'missing encoder.bn1.running_var' in str(err.value)
    with pytest.raises(KeyError):
        jax_convert.convert_checkpoint(lm, 'Unet', 'resnet18')
    # a conv bias the model's conv has not: refused by both
    extra = {**sd, 'encoder.conv1.bias': np.zeros(64, np.float32)}
    with pytest.raises(ValueError, match=r'unexpected encoder\.conv1\.bias'):
        convert_torch.model_state_dict(extra, 'Unet', 'resnet18', 1)
    variables = jax_convert.convert_checkpoint(extra, 'Unet', 'resnet18')
    assert 'bias' in variables['params']['encoder']['ConvBNAct_0']['Conv_0']


def test_unconsumed_keys_are_logged_and_num_batches_tracked_tolerated(tmp_path, caplog):
    sd = _smp_state_dict('Unet', 'resnet18', 1, 'mirror', 0)
    sd = {f'model.{k}': v for k, v in sd.items() if not k.endswith('num_batches_tracked')}
    sd['model.encoder.fc.weight'] = np.zeros((10, 512), np.float32)   # dropped silently
    sd['model.aux.weight'] = np.zeros((10, 512), np.float32)
    sd['model.aux.num_batches_tracked'] = np.zeros((), np.int64)
    sd['mean'] = sd['model.std'] = np.ones((1, 3, 1, 1), np.float32)
    with caplog.at_level(logging.WARNING):
        out = convert_torch.model_state_dict(sd, 'Unet', 'resnet18', 1)
        jax_convert.convert_checkpoint(sd, 'Unet', 'resnet18')
    assert not any(k.endswith('num_batches_tracked') for k in out)
    said = {r.name: r.getMessage() for r in caplog.records}
    message = "unconsumed torch keys: ['model.aux.weight']"
    assert said == {'octseg_torch.models.convert_torch': message,
                    'octseg.models.convert_torch': message}


def test_reader_keeps_weights_only_and_names_a_refused_global(tmp_path):
    import argparse

    sd = _smp_state_dict('Unet', 'resnet18', 1, 'mirror', 0)
    payload = {'state_dict': {k: torch.from_numpy(v) for k, v in sd.items()},
               'hyper_parameters': argparse.Namespace(lr=1e-4)}
    path = str(tmp_path / 'weights.ckpt')
    torch.save(payload, path)
    with pytest.raises(pickle.UnpicklingError, match='argparse.Namespace'):
        convert_torch.load_torch_state_dict(path)
    got = jax_convert.load_torch_state_dict(path)   # octseg reads it, unsafely
    assert set(got) == set(sd)
