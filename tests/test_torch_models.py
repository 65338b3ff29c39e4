"""octseg_torch models against the JAX package's flax models.

A flax model gets random variables from a numpy seed, they cross the weights
bridge (octseg_torch.models.convert.variables_to_state_dict) into the port's
model, and both run the same numpy input in fp32 on the CPU. Tolerance 2e-3,
as tests/test_convert_torch.py holds converted checkpoints: the two
frameworks sum convolutions in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.models import create_model as jax_create_model
from octseg_torch.models import create_model
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
])
def test_forward_parity_with_jax(arch, encoder, size, frames):
    want, got = _forward_pair(arch, encoder, size, frames)
    assert got.shape == want.shape == (frames, size, size, 2)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err < 2e-3, f'{arch}/{encoder}: max abs err {err} (logit scale {np.abs(want).max()})'
