"""The zoo's weights, shared with the JAX package: FPN, PSPNet, PAN, MAnet,
DeepLabV3 and DeepLabV3Plus.

- The bridge: a port state_dict -> octseg's ``convert_checkpoint`` (the
  reference's torch-to-flax converter) -> the port's
  ``variables_to_state_dict`` is exact, and the port's own inverse builds
  the tree octseg's converter builds.
- ``weights.ckpt``: a file the port writes is read by octseg, which writes
  it again byte for byte and restores it into its model's variables (flax's
  ``from_state_dict`` checks every leaf's path against the model's); a file
  octseg writes (random variables of its model, from a numpy seed) is read
  by the port, which writes it again byte for byte.
- One ``train_model`` -> ``evaluate`` round trip on the CPU for FPN and
  DeepLabV3Plus (the upsampled-head and dilated-encoder groups, as octseg's
  slow tests/test_train_new_decoders.py picks them), small: the port trains
  at 64 px for two epochs, and both packages' evaluate score the port's
  model dir within 1e-5 of each other.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.models import create_model as jax_create_model
from octseg.models.convert_torch import convert_checkpoint
from octseg.train import checkpoint as jax_ckpt
from octseg.train.evaluate import evaluate_model as jax_evaluate_model
from octseg_torch.core.config import Config
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.models import create_model
from octseg_torch.models.convert import state_dict_to_variables, variables_to_state_dict
from octseg_torch.train import checkpoint as ckpt
from octseg_torch.train import evaluate
from octseg_torch.train.train import train_model
from tests.test_torch_checkpoint import _assert_tree_equal, _random_state_dict
from tests.test_torch_models import _random_variables
from tests.test_torch_zoo import ZOO, _size

PAIRS = [(a, 'resnet18') for a in ZOO] + [
    ('FPN', 'efficientnet-b0'), ('PSPNet', 'timm-regnetx_002'), ('PAN', 'timm-regnetx_002'),
    ('MAnet', 'efficientnet-b0'), ('DeepLabV3', 'timm-regnetx_002'),
    ('DeepLabV3Plus', 'efficientnet-b0')]


@pytest.mark.parametrize('arch,encoder', PAIRS)
def test_zoo_bridge_round_trip_through_convert_checkpoint(arch, encoder):
    sd = _random_state_dict(arch, encoder, seed=5)
    variables = convert_checkpoint(sd, arch, encoder)
    back = variables_to_state_dict(variables, arch, encoder)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype, k
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    _assert_tree_equal(state_dict_to_variables(sd, arch, encoder), variables)
    ckpt._load_checked(create_model(arch, encoder, classes=2), back, 'bridge')


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, emptied when the test ends: each test here writes
    100-330 MB of checkpoints, and the test runner's temporary disk is
    shared."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def one_thread():
    """One intra-op thread while the port trains: the test runner's workers
    share the cores, and eight threads per worker oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('arch', ZOO)
def test_zoo_weights_ckpt_byte_for_byte_both_ways(scratch, arch):
    classes = ['Lipid core', 'Fibrous cap']
    fm = jax_create_model(arch, 'resnet18', classes=len(classes))
    x = jnp.zeros((1, _size(arch), _size(arch), 3))
    template = jax.eval_shape(lambda: fm.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)}, x, train=False))

    # the port writes; octseg reads, writes again and restores into its model
    port_dir = ckpt.initialize_model_dir(str(scratch / 'port'), classes, arch, 'resnet18',
                                         input_size=128, seed=1)
    port_file = os.path.join(port_dir, 'weights.ckpt')
    again = str(scratch / 'octseg_again.ckpt')
    raw = jax_ckpt.load_weights(port_file)
    jax_ckpt.save_weights(again, raw['params'], raw['batch_stats'])
    assert _read(again) == _read(port_file)
    restored = jax_ckpt.restore_weights_into(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template), port_file)
    assert jax.tree.structure(restored) == jax.tree.structure(
        {'params': template['params'], 'batch_stats': template['batch_stats']})

    # octseg writes; the port reads and writes again
    variables = _random_variables(fm, x, 2)
    jax_file = str(scratch / 'octseg.ckpt')
    jax_ckpt.save_weights(jax_file, variables['params'], variables['batch_stats'])
    model = create_model(arch, 'resnet18', classes=len(classes))
    ckpt.restore_weights_into(model, jax_file, arch, 'resnet18')
    port_again = str(scratch / 'port_again.ckpt')
    ckpt.save_model_weights(port_again, model, arch, 'resnet18')
    assert _read(port_again) == _read(jax_file)


@pytest.fixture(scope='module')
def fold(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('zoo_fold') / 'fold')
    make_synth_fold(path, n_train=8, n_test=4, size=80, seed=4)
    return path


@pytest.mark.parametrize('arch', ['FPN', 'DeepLabV3Plus'])
def test_zoo_train_then_evaluate_in_both_packages(scratch, fold, arch, one_thread):
    cfg = Config(data_dir=fold, classes=['Lumen'], architecture=arch, encoder='resnet18',
                 optimizer='Adam', lr=1e-3, weight_decay=0.0, input_size=64, batch_size=4,
                 epochs=2, use_augmentation=True, save_dir=str(scratch / 'models'),
                 model_name=f'smoke_{arch}', seed=11)
    summary = train_model(cfg, device='cpu')
    assert summary['epochs_done'] == 2 and summary['train_steps'] == 4
    model_dir = summary['model_dir']
    for name in ('weights.ckpt', 'config.json', 'metrics.csv', 'resume.ckpt'):
        assert os.path.isfile(os.path.join(model_dir, name)), name
    got = evaluate.evaluate_model(model_dir, fold, batch_size=4, device='cpu')
    want = jax_evaluate_model(model_dir, fold, batch_size=4)
    assert list(got) == list(want) == ['Lumen', 'Mean']
    for cl in want:
        assert list(got[cl]) == list(want[cl])
        for k, v in want[cl].items():
            assert abs(got[cl][k] - v) <= 1e-5, (cl, k, got[cl][k], v)
    assert 0.0 <= got['Lumen']['dice'] <= 1.0
