"""octseg_torch models against the JAX package's flax models.

A flax model gets random variables from a numpy seed, they cross the weights
bridge (octseg_torch.models.convert.variables_to_state_dict) into the port's
model, and both run the same numpy input in fp32 on the CPU. Tolerance 2e-3,
as tests/test_convert_torch.py holds converted checkpoints: the two
frameworks sum convolutions in different orders. The two winning 896 px
models (LinkNet/efficientnet-b7, Unet/timm-regnetx_064) are in
tests/test_torch_winners.py.

``Conv2dSame`` is held to ``jax.lax.conv_general_dilated(padding='SAME')``
within 1e-5 (float32 sums of at most 5x5x4 products of unit-scale values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.models import create_model as jax_create_model
from octseg_torch.models import create_model
from octseg_torch.models.common import Conv2dSame
from octseg_torch.models.convert import variables_to_state_dict


def _random_variables(fm, x, seed):
    """Variables of flax model ``fm`` for input ``x``: conv kernels
    N(0, 1/fan_in), biases and BatchNorm offsets N(0, 0.1), BatchNorm scales
    and variances U(0.5, 1.5) (random statistics exercise the batch_stats
    half of the bridge). Shapes come from eval_shape: no init compile."""
    shapes = jax.eval_shape(lambda: fm.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)}, x, train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            v = rng.normal(0, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.1, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _forward_pair(arch, encoder, size, frames, classes=2, seed=0):
    fm = jax_create_model(arch, encoder, classes=classes)
    x = np.random.default_rng(seed).normal(size=(frames, size, size, 3)).astype(np.float32)
    variables = _random_variables(fm, jnp.asarray(x), seed + 1)
    want = np.asarray(jax.jit(lambda v, x: fm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))

    tm = create_model(arch, encoder, classes=classes).eval()
    sd = variables_to_state_dict(variables, arch, encoder)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return want, got


@pytest.mark.parametrize('arch,encoder,size,frames', [
    ('Unet', 'resnet18', 64, 2),
    ('UnetPlusPlus', 'resnet18', 64, 2),
    ('UnetPlusPlus', 'resnet101', 32, 1),
    ('LinkNet', 'resnet18', 64, 2),
    ('LinkNet', 'efficientnet-b0', 64, 2),
    ('Unet', 'timm-regnetx_002', 64, 2),
])
def test_forward_parity_with_jax(arch, encoder, size, frames):
    want, got = _forward_pair(arch, encoder, size, frames)
    assert got.shape == want.shape == (frames, size, size, 2)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err < 2e-3, f'{arch}/{encoder}: max abs err {err} (logit scale {np.abs(want).max()})'


@pytest.mark.parametrize('size', [31, 32, 33])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('kernel', [3, 5])
@pytest.mark.parametrize('depthwise', [False, True])
def test_same_padding_matches_xla(size, stride, kernel, depthwise):
    """XLA's SAME padding is asymmetric for stride 2 on even sizes: a
    symmetric padding=k//2 would shift every stride-2 window by a pixel."""
    cin = 4
    cout, groups = (cin, cin) if depthwise else (6, 1)
    rng = np.random.default_rng(size * 100 + stride * 10 + kernel)
    x = rng.normal(size=(2, size, size + 1, cin)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, cin // groups, cout)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), 'SAME',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'), feature_group_count=groups,
        precision=jax.lax.Precision.HIGHEST))
    conv = Conv2dSame(cin, cout, kernel, stride, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
