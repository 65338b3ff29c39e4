"""Whole-model int8 logits of the port against octseg's ``apply_int8``.

Unet/resnet18, UNet++/resnet18 and LinkNet/efficientnet-b0 at 64 px, batch
2, in fp32 and bf16 compute, from the same weights and inputs (numpy,
seeded). Both run the same number of int8 convolutions, more than 0, so no
case passes with int8 switched off.

Tolerance. The int8 values are octseg's bit for bit on the same float
inputs (tests/test_torch_quantize.py), but the two frameworks' float32 (and
bf16) activations differ by an ulp here and there, and an activation on a
.5 boundary of ``x * 127 / sa`` then rounds to the other int8 value, which
moves everything after it by a quantization step; deeper layers flip more
(measured on UNet++/resnet18 in fp32: one int8 value of 16,384 flips in
the encoder's third stage, 318 of 8,192 two blocks later). So the port's
int8 logits are held to the size of int8's own error, measured from the
fp32 logits of the same model (``exact``):

- the mean |port int8 - exact| within MEAN_RATIO of the mean |octseg int8 -
  exact| (measured 0.98-1.10);
- the largest |port int8 - octseg int8| within MAX_RATIO of the largest
  |octseg int8 - exact| (measured 0.0-1.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.models import create_model as jax_create_model
from octseg.ops import quantize as jq
from octseg_torch.models import create_model
from octseg_torch.models.convert import variables_to_state_dict
from octseg_torch.ops import quantize
from tests.test_torch_models import _random_variables
from tests.torch_threads import torch_threads_share  # noqa: F401

FAMILIES = [('Unet', 'resnet18'), ('UnetPlusPlus', 'resnet18'), ('LinkNet', 'efficientnet-b0')]
MEAN_RATIO = 1.25
MAX_RATIO = 2.0


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('arch,encoder', FAMILIES, ids=[a for a, _e in FAMILIES])
def test_int8_logits_within_int8s_own_error_of_octsegs(arch, encoder, bf16, monkeypatch):
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = _random_variables(jax_create_model(arch, encoder, classes=2), jnp.asarray(x), 1)
    fm = jax_create_model(arch, encoder, classes=2, dtype=jnp.bfloat16 if bf16 else None)
    octseg_calls = []
    real_jq = jq.quantized_conv
    monkeypatch.setattr(jq, 'quantized_conv',
                        lambda *a: octseg_calls.append(a[3].name) or real_jq(*a))
    want = np.asarray(jax.jit(lambda v, x: jq.apply_int8(fm, v, x, train=False))(
        variables, jnp.asarray(x)).astype(jnp.float32))

    state = variables_to_state_dict(variables, arch, encoder)
    tm, fp32 = (create_model(arch, encoder, classes=2, dtype=dt).eval()
                for dt in (torch.bfloat16 if bf16 else torch.float32, torch.float32))
    for m in (tm, fp32):
        m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    port_calls = []
    real = quantize.quantized_conv
    monkeypatch.setattr(quantize, 'quantized_conv',
                        lambda conv, x, pads: port_calls.append(conv) or real(conv, x, pads))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = quantize.apply_int8(tm, xt).float().permute(0, 2, 3, 1).numpy()
        exact = fp32(xt).permute(0, 2, 3, 1).numpy()

    assert len(port_calls) == len(octseg_calls) > 0
    assert got.shape == want.shape and np.isfinite(got).all()
    octseg_error = np.abs(want - exact)
    assert octseg_error.max() > 0
    assert np.abs(got - exact).mean() <= MEAN_RATIO * octseg_error.mean()
    assert np.abs(got - want).max() <= MAX_RATIO * octseg_error.max()
