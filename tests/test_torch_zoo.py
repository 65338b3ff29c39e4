"""The rest of the model zoo, octseg_torch against the JAX package's flax
models on the CPU: FPN, PSPNet, PAN, MAnet, DeepLabV3 and DeepLabV3Plus.

Random variables from a numpy seed cross the weights bridge
(tests/test_torch_models.py's helpers) into the port's model.

Eval mode: logits within 2e-3 of octseg's, at octseg's own converter test
shapes (tests/test_convert_torch.py): resnet18 at 64 px (PAN at 128: its
FPA pyramid needs a deepest map of at least 8 px), plus FPN/efficientnet-b0,
MAnet/timm-regnetx_002, PAN/efficientnet-b0 and
DeepLabV3Plus/timm-regnetx_002. Train mode is in
tests/test_torch_zoo_train.py.
"""

import numpy as np
import pytest

from tests.test_torch_models import _forward_pair
from tests.torch_threads import torch_threads_share  # noqa: F401

ZOO = ['FPN', 'PSPNet', 'PAN', 'MAnet', 'DeepLabV3', 'DeepLabV3Plus']
CLASSES = 2


def _size(arch):
    return 128 if arch == 'PAN' else 64


@pytest.mark.parametrize('arch,encoder', [(a, 'resnet18') for a in ZOO] + [
    ('FPN', 'efficientnet-b0'), ('MAnet', 'timm-regnetx_002'), ('PAN', 'efficientnet-b0'),
    ('DeepLabV3Plus', 'timm-regnetx_002')])
def test_zoo_forward_parity_with_jax(arch, encoder):
    size = _size(arch)
    want, got = _forward_pair(arch, encoder, size, 2)
    assert got.shape == want.shape == (2, size, size, CLASSES)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err < 2e-3, f'{arch}/{encoder}: max abs err {err} (logit scale {np.abs(want).max()})'

