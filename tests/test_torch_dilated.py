"""The dilated encoders, octseg_torch against the JAX package on the CPU.

Each family's feature pyramid (resnet18, timm-regnetx_002,
efficientnet-b0) at output strides 8 and 16, through the models that use
them (DeepLabV3 at 8, DeepLabV3Plus at 16): random variables from a numpy
seed cross the weights bridge, and every level of the pyramid must agree
within 1e-4. efficientnet runs at 72 and 80 px, sizes that are not a
multiple of 32, where XLA's SAME padding of a dilated depthwise conv is
asymmetric and uses the dilated kernel (k-1)·d+1; so does the conv alone.
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
from tests.test_torch_models import _random_variables

ARCH_OF_STRIDE = {8: 'DeepLabV3', 16: 'DeepLabV3Plus'}


@pytest.mark.parametrize('encoder,size', [
    ('resnet18', 64), ('timm-regnetx_002', 64), ('efficientnet-b0', 72),
    ('efficientnet-b0', 80)])
@pytest.mark.parametrize('stride', [8, 16])
def test_dilated_pyramid_matches_jax(encoder, size, stride):
    arch = ARCH_OF_STRIDE[stride]
    fm = jax_create_model(arch, encoder, classes=1)
    x = np.random.default_rng(size + stride).normal(size=(2, size, size, 3)).astype(np.float32)
    variables = _random_variables(fm, jnp.asarray(x), stride)
    want = jax.jit(lambda v, x: fm.apply(v, x, train=False, method=fm.encode))(
        variables, jnp.asarray(x))

    tm = create_model(arch, encoder, classes=1).eval()
    sd = variables_to_state_dict(variables, arch, encoder)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    # the pyramid stops halving at the output stride
    assert tuple(got[5].shape[-2:]) == tuple(got[4 if stride == 16 else 3].shape[-2:])
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, level
        err = np.abs(g - w).max()
        assert err <= 1e-4, f'{encoder} at {stride}, level {level}: {err} (scale {np.abs(w).max()})'


@pytest.mark.parametrize('size', [72, 80, 31])
@pytest.mark.parametrize('dilation', [2, 4])
@pytest.mark.parametrize('kernel', [3, 5])
def test_same_padding_with_dilation_matches_xla(size, dilation, kernel):
    """A depthwise conv with dilation, stride 1, XLA SAME: padding
    (k-1)·d split with the odd pixel after."""
    cin = 4
    rng = np.random.default_rng(size * 100 + dilation * 10 + kernel)
    x = rng.normal(size=(2, size, size + 3, cin)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 1, cin)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), 'SAME', rhs_dilation=(dilation, dilation),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'), feature_group_count=cin,
        precision=jax.lax.Precision.HIGHEST))
    conv = Conv2dSame(cin, cin, kernel, 1, groups=cin, dilation=dilation)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
