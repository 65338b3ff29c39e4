"""bf16 compute and block remat for the rest of the model zoo (FPN, PSPNet,
PAN, MAnet, DeepLabV3, DeepLabV3Plus), octseg_torch against the JAX package
on the CPU, as tests/test_torch_bf16.py holds the ensemble's families.

- bf16 logits (eval mode): the port's distance from octseg's fp32 logits
  within twice octseg's own bf16 distance from them, and not 0 (a model that
  silently computed in fp32 fails). This reaches the zoo's float32 islands
  in bf16: GroupNorm (FPN), the align_corners resizes (PSPNet, PAN, the
  DeepLab heads) and MAnet's attention.
- One train step with remat on against the same step with remat off, in
  fp32 and in bf16, with dropout on (both draw from one generator seed):
  equal loss, gradients within 1e-6 (fp32) or equal (bf16), equal
  BatchNorm statistics (tests/test_torch_bf16.py's bounds).
- bf16 with remat in train mode against octseg's fp32 and bf16 steps:
  tests/test_torch_zoo_train.py and its dilated companion.
"""

import numpy as np
import pytest
import torch

from octseg_torch.models import create_model
from octseg_torch.train.train import init_model
from tests.test_torch_bf16 import _assert_stats_equal, _bf16_triple, _step_grads
from tests.test_torch_zoo import ZOO, _size
from tests.test_torch_zoo_convert import one_thread  # noqa: F401 (a fixture)
from tests.torch_threads import torch_threads_share  # noqa: F401

# encoders: resnet at output strides 8 (DeepLabV3), 16 (PAN) and 32, and
# SAME-dilated efficientnet at 16 (DeepLabV3Plus)
PAIRS = [('FPN', 'resnet18'), ('PSPNet', 'resnet18'), ('PAN', 'resnet18'),
         ('MAnet', 'resnet18'), ('DeepLabV3', 'resnet18'),
         ('DeepLabV3Plus', 'efficientnet-b0')]


def test_pairs_cover_the_zoo():
    assert sorted(a for a, _ in PAIRS) == sorted(ZOO)


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('arch,encoder', PAIRS)
def test_zoo_bf16_logits_as_close_to_fp32_as_octsegs_bf16(arch, encoder):
    want32, want16, got = _bf16_triple(arch, encoder, size=_size(arch))
    assert np.isfinite(got).all()
    jax_gap = float(np.abs(want16 - want32).max())
    port_gap = float(np.abs(got - want32).max())
    assert jax_gap > 0 and port_gap > 0, 'a bf16 model computed in fp32'
    assert port_gap <= 2 * jax_gap, (
        f'{arch}/{encoder}: port bf16 {port_gap:.4g} from fp32, octseg bf16 {jax_gap:.4g}')


def _steps(arch, encoder):
    """{(dtype, remat): (loss, grads, stats)} of one step from the same
    weights (fp32 parameters), batch of 2 frames and dropout draws."""
    size = _size(arch)
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, size, size, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.random((2, size, size, 2)) > 0.6).astype(np.float32))
    base = init_model(create_model(arch, encoder, classes=2), seed=1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for remat in (False, True):
            model = create_model(arch, encoder, classes=2, dtype=dtype, remat=remat)
            model.load_state_dict(base.state_dict())
            out[dtype, remat] = _step_grads(model, imgs, masks)
    return out


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('arch,encoder', PAIRS)
def test_zoo_remat_step_equals_plain_step(arch, encoder):
    steps = _steps(arch, encoder)
    loss, grads, stats = steps[torch.float32, False]
    rloss, rgrads, rstats = steps[torch.float32, True]
    assert abs(loss - rloss) <= 1e-6 * abs(loss)
    for k in grads:
        np.testing.assert_allclose(rgrads[k].numpy(), grads[k].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(grads[k].abs().max()), err_msg=k)
    _assert_stats_equal(rstats, stats)

    bloss, bgrads, bstats = steps[torch.bfloat16, False]
    brloss, brgrads, brstats = steps[torch.bfloat16, True]
    assert bloss == brloss
    for k in bgrads:
        assert torch.equal(brgrads[k], bgrads[k]), k
    _assert_stats_equal(brstats, bstats)

    assert bloss != loss, 'a bf16 step computed in fp32'
    assert set(bgrads) == set(grads)
    assert all(g.dtype == torch.float32 for g in bgrads.values())
