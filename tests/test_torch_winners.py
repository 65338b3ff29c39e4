"""The two winning 896 px models of the reference's ensemble, octseg_torch
against the JAX package: LinkNet/efficientnet-b7 (FC_LC) and
Unet/timm-regnetx_064 (VV), one 32 px frame, random variables carried over
by the weights bridge (tests/test_torch_models.py's helper). Tolerance
2e-3, as tests/test_convert_torch.py holds converted checkpoints. Their own
file lets the test runner's per-file workers run them beside the rest.
"""

import numpy as np
import pytest

from tests.test_torch_models import _forward_pair


@pytest.mark.parametrize('arch,encoder', [
    ('LinkNet', 'efficientnet-b7'),
    ('Unet', 'timm-regnetx_064'),
])
def test_winner_forward_parity_with_jax(arch, encoder):
    want, got = _forward_pair(arch, encoder, size=32, frames=1)
    assert got.shape == want.shape == (1, 32, 32, 2)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err < 2e-3, f'{arch}/{encoder}: max abs err {err} (logit scale {np.abs(want).max()})'
