"""octseg_torch weights and config I/O against the JAX package.

- the port's msgpack codec against flax's (both directions, byte-identical);
- the weights bridge: port state_dict -> octseg.models.convert_torch
  .convert_checkpoint -> octseg_torch variables_to_state_dict is bit-exact,
  for each ported encoder family and decoder;
- the initializer draws every conv and transposed conv from its seed;
- the port's YAML-subset reader against yaml.safe_load on the repo's configs.
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import octseg
from octseg.core import config as jax_config
from octseg.models import create_model as jax_create_model
from octseg.models.convert_torch import convert_checkpoint
from octseg.train import checkpoint as jax_checkpoint
from octseg_torch.core import config as torch_config
from octseg_torch.models import create_model
from octseg_torch.models.convert import state_dict_to_variables, variables_to_state_dict
from octseg_torch.models.encoders import create_encoder
from octseg_torch.train import checkpoint as torch_checkpoint
from octseg_torch.train.train import init_model


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        'params': {
            'encoder': {'Conv_0': {'kernel': rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                                   'bias': rng.normal(size=(8,)).astype(np.float32)}},
            'head': {'w' * 40: rng.integers(-5, 5, (300,)).astype(np.int64)},
        },
        'batch_stats': {'m': np.float32(3.25), 'v': np.ones((), np.float64),
                        'h': rng.normal(size=(2, 17)).astype(np.float16)},
        'meta': [1, -7, 200, -200, 70000, -70000, 2 ** 40, 1.5, True, None, 's' * 40, b'x'],
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_msgpack_flax_writes_port_reads():
    tree = _tree(0)
    _assert_tree_equal(torch_checkpoint.restore(serialization.msgpack_serialize(tree)), tree)


def test_msgpack_port_writes_flax_reads_byte_identical():
    tree = _tree(1)
    data = torch_checkpoint.serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _assert_tree_equal(serialization.msgpack_restore(data), tree)


def test_weights_file_both_ways(tmp_path):
    tree = _tree(2)
    jax_path, torch_path = str(tmp_path / 'j.ckpt'), str(tmp_path / 't.ckpt')
    jax_checkpoint.save_weights(jax_path, tree['params'], tree['batch_stats'])
    torch_checkpoint.save_weights(torch_path, tree['params'], tree['batch_stats'])
    want = {'params': tree['params'], 'batch_stats': tree['batch_stats']}
    _assert_tree_equal(torch_checkpoint.load_weights(jax_path), want)
    _assert_tree_equal(jax_checkpoint.load_weights(torch_path), want)


def _random_state_dict(arch, encoder, seed):
    model = create_model(arch, encoder, classes=2)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if v.dtype.is_floating_point:
            sd[k] = torch.randn(v.shape, generator=gen).numpy()
            if k.endswith('running_var'):
                sd[k] = np.abs(sd[k]) + 0.5
        else:
            sd[k] = np.zeros(v.shape, np.int64)  # num_batches_tracked
    return sd


@pytest.mark.parametrize('arch,encoder', [
    ('Unet', 'resnet18'), ('UnetPlusPlus', 'resnet18'), ('Unet', 'resnet50'),
    ('UnetPlusPlus', 'resnet101'), ('LinkNet', 'resnet18'), ('LinkNet', 'efficientnet-b0'),
    ('Unet', 'timm-regnetx_002'), ('Unet', 'timm-regnety_120'),
    ('LinkNet', 'efficientnet-b7'), ('Unet', 'timm-regnetx_064'),
])
def test_bridge_round_trip_through_convert_checkpoint(arch, encoder):
    sd = _random_state_dict(arch, encoder, seed=3)
    variables = convert_checkpoint(sd, arch, encoder)
    back = variables_to_state_dict(variables, arch, encoder)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype, k
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    # the inverse builds exactly the tree convert_checkpoint builds
    _assert_tree_equal(state_dict_to_variables(sd, arch, encoder), variables)
    # and the result loads with no missing, unexpected or misshapen key
    torch_checkpoint._load_checked(create_model(arch, encoder, classes=2), back, 'bridge')


def test_bridge_loads_into_the_port_model():
    sd = _random_state_dict('UnetPlusPlus', 'resnet18', seed=4)
    model = create_model('UnetPlusPlus', 'resnet18', classes=2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})


def test_initialize_model_dir_loads_in_jax(tmp_path):
    from octseg.infer.engine import load_model_bundle

    model_dir = torch_checkpoint.initialize_model_dir(
        str(tmp_path / 'LM'), ['Lumen'], 'Unet', 'resnet18', input_size=32, seed=0)
    _model, variables, cfg = load_model_bundle(model_dir)
    assert cfg['architecture'] == 'Unet' and cfg['normalize'] is True
    kernel = variables['params']['head']['Conv_0']['kernel']
    assert kernel.shape == (3, 3, 16, 1)


def test_create_model_names_the_roadmap_item_for_unported_pairs():
    for arch in ('FPN', 'PSPNet', 'PAN', 'MAnet', 'DeepLabV3', 'DeepLabV3Plus'):
        with pytest.raises(NotImplementedError, match='ROADMAP.md "The rest of the model zoo"'):
            create_model(arch, 'resnet18')
        with pytest.raises(NotImplementedError, match='"The rest of the model zoo"'):
            state_dict_to_variables({}, arch, 'resnet18')
    with pytest.raises(NotImplementedError, match='ROADMAP.md "The rest of the model zoo"'):
        create_encoder('efficientnet-b7', output_stride=16)
    # what octseg does not know is a ValueError there and here
    for arch, encoder in (('SegFormer', 'resnet18'), ('Unet', 'vgg16')):
        with pytest.raises(ValueError):
            jax_create_model(arch, encoder)
        with pytest.raises(ValueError):
            create_model(arch, encoder)


@pytest.mark.parametrize('init', ['initialize_model_dir', 'init_model'])
def test_initializers_draw_transposed_convs_from_the_seed(tmp_path, init):
    """LinkNet's ConvTranspose2d weights come from the seed, N(0, 1/fan_in)
    with fan_in = out_channels x 16 (flax's lecun fan-in of its (4, 4, out,
    in) kernel), not from torch's default init and the global RNG."""
    def draw(seed, tag):
        if init == 'init_model':
            return init_model(create_model('LinkNet', 'resnet18'), seed)
        model_dir = torch_checkpoint.initialize_model_dir(
            str(tmp_path / tag), ['Lumen'], 'LinkNet', 'resnet18', input_size=32, seed=seed)
        model = create_model('LinkNet', 'resnet18')
        torch_checkpoint.restore_weights_into(model, os.path.join(model_dir, 'weights.ckpt'),
                                              'LinkNet', 'resnet18')
        return model

    def transposed(model):
        return [m.weight.detach().clone() for m in model.modules()
                if isinstance(m, torch.nn.ConvTranspose2d)]

    torch.manual_seed(1)
    a = transposed(draw(0, 'a'))
    torch.manual_seed(2)
    b = transposed(draw(0, 'b'))
    c = transposed(draw(1, 'c'))
    assert len(a) == 5
    for wa, wb, wc in zip(a, b, c):
        assert torch.equal(wa, wb) and not torch.equal(wa, wc)
        fan_in = wa.shape[1] * 16
        assert abs(float(wa.std()) * fan_in ** 0.5 - 1) < 0.1, (tuple(wa.shape), float(wa.std()))


CONFIGS = sorted(glob.glob(os.path.join(octseg.PROJECT_DIR, 'configs', '*.yaml')))


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert torch_config.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize('name', ['main', 'predict'])
def test_load_config_matches_jax(name):
    overrides = ['classes=[Lumen,\'Fibrous cap\']', 'output_size=[500,400]',
                 'lr=1e-5', 'block_size=16', 'a.b.c=true', 'device=cpu', 'x=null']
    want = jax_config.load_config(name, overrides=overrides)
    got = torch_config.load_config(name, overrides=overrides)
    assert got.to_dict() == want.to_dict()
    assert got.a.b.c is True


@pytest.mark.parametrize('raw', [
    '1e-5', '0.00001', '-3', '1_000', '.5', 'yes', 'Off', '~', 'null', "'it''s'",
    '"a#b"', '[1, [2, 3], \'x y\']', 'plain text', '[Lumen, Vasa vasorum]', '.inf',
])
def test_override_values_match_jax(raw):
    want = jax_config.parse_overrides([f'k={raw}'])['k']
    got = torch_config.parse_overrides([f'k={raw}'])['k']
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize('text', [
    'a: &x 1\nb: *x\n', 'a: {b: 1}\n', 'a:\n- b: 1\n', 'a: |\n  text\n',
    'a: 0x1f\n', 'a: 2001-12-14\n', 'a: 1\na: 2\n', '---\na: 1\n',
])
def test_yaml_reader_rejects_what_it_does_not_support(text):
    with pytest.raises(torch_config.YamlSubsetError):
        torch_config.load_yaml(text)
