"""bf16 compute and block remat in octseg_torch against the JAX package.

bf16 (octseg's ``dtype=bfloat16``): parameters stay float32, every
convolution computes in bfloat16 and BatchNorm in float32. For each family
of the ensemble at 32 px (Unet/resnet18, LinkNet/efficientnet-b0,
Unet/timm-regnetx_002, UNet++/resnet18), the port's bf16 logits must lie
within twice the max-abs distance of octseg's own bf16 logits from octseg's
fp32 logits: the two frameworks round bf16 sums in different orders, so
each bf16 forward is its own rounding of the fp32 one, and the bound asks
the port's rounding to be of the same size as octseg's (measured: 1.3e-2
against 9.1e-3 for Unet/resnet18, 6.5e-3 against 6.3e-3 for LinkNet,
3.6e-3 against 3.5e-3 for Unet/regnet, 1.5e-2 against 1.0e-2 for UNet++,
logits up to about 0.85). One bf16 train step (Unet/resnet18 at 64 px,
Adam) gives octseg's bf16 loss within 1e-3 relative (measured 1.2e-4; the
dice loss sums every pixel, so octseg's own bf16 loss is 2.6e-5 from its
fp32 loss) with float32 parameters and running statistics.

Remat: one training step of each family with remat on and off, from the
same weights and batch, gives equal loss and gradients within 1e-6 (the
recomputed forward runs the same kernels on the same inputs) and equal
BatchNorm running statistics to 1e-7; a control that lets the recomputed
BatchNorms move their statistics again must fail the statistics check.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.models import create_model as jax_create_model
from octseg_torch.models import create_model
from octseg_torch.models import remat as remat_mod
from octseg_torch.models.common import set_dropout_generator
from octseg_torch.models.convert import variables_to_state_dict
from octseg_torch.train.train import _loss_and_logits, init_model
from tests.test_torch_models import _random_variables

FAMILIES = [('Unet', 'resnet18'), ('LinkNet', 'efficientnet-b0'),
            ('Unet', 'timm-regnetx_002'), ('UnetPlusPlus', 'resnet18')]


def _bf16_triple(arch, encoder, size=32, frames=2, seed=0):
    """(octseg fp32, octseg bf16, port bf16) logits, NHWC, same weights."""
    x = np.random.default_rng(seed).normal(0, 1, (frames, size, size, 3)).astype(np.float32)
    fm32 = jax_create_model(arch, encoder, classes=2)
    variables = _random_variables(fm32, jnp.asarray(x), seed + 1)
    fm16 = jax_create_model(arch, encoder, classes=2, dtype=jnp.bfloat16)
    want32, want16 = (np.asarray(jax.jit(lambda v, x: fm.apply(v, x, train=False))(
        variables, jnp.asarray(x))) for fm in (fm32, fm16))
    tm = create_model(arch, encoder, classes=2, dtype=torch.bfloat16).eval()
    sd = variables_to_state_dict(variables, arch, encoder)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    return want32, want16, got.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('arch,encoder', FAMILIES)
def test_bf16_logits_as_close_to_fp32_as_octsegs_bf16(arch, encoder):
    want32, want16, got = _bf16_triple(arch, encoder)
    assert np.isfinite(got).all()
    jax_gap = float(np.abs(want16 - want32).max())
    port_gap = float(np.abs(got - want32).max())
    assert jax_gap > 0 and port_gap > 0, 'a bf16 model computed in fp32'
    assert port_gap <= 2 * jax_gap, (
        f'{arch}/{encoder}: port bf16 {port_gap:.4g} from fp32, octseg bf16 {jax_gap:.4g}')


def test_bf16_train_step_loss_matches_octseg():
    """One bf16 training step's loss (Unet/resnet18 at 64 px, batch 2, two
    classes) against octseg's bf16 step from the same weights and batch."""
    from octseg.ops.normalize import normalize_imagenet
    from octseg.train.losses import dice_loss_from_logits as jax_dice
    from octseg_torch.train.state import TrainState, make_optimizer
    from octseg_torch.train.train import make_train_step

    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    masks = (rng.random((2, 64, 64, 2)) > 0.6).astype(np.float32)
    fm = jax_create_model('Unet', 'resnet18', classes=2, dtype=jnp.bfloat16)
    variables = _random_variables(fm, jnp.asarray(imgs), 5)
    def jax_loss(params):
        logits, _ = fm.apply({'params': params, 'batch_stats': variables['batch_stats']},
                             normalize_imagenet(jnp.asarray(imgs)), train=True,
                             mutable=['batch_stats'])
        return jax_dice(logits, jnp.asarray(masks))

    want = float(jax.jit(jax_loss)(variables['params']))
    tm = create_model('Unet', 'resnet18', classes=2, dtype=torch.bfloat16)
    sd = variables_to_state_dict(variables, 'Unet', 'resnet18')
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    state = TrainState.create(tm, make_optimizer('Adam', 1e-3))
    metrics = make_train_step(use_augmentation=False)(
        state, torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator())
    got = float(metrics['loss'])
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for n, b in tm.named_buffers() if 'running' in n)


def _step_grads(model, imgs, masks):
    model.train()
    # the zoo's dropouts (tests/test_torch_zoo_bf16.py) draw the same masks
    # on every call
    set_dropout_generator(model, torch.Generator().manual_seed(11))
    loss, _, _ = _loss_and_logits(model, imgs, masks)
    loss.backward()
    # PSPNet reads its encoder to depth 3: the last stage has no gradient
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: b.detach().clone() for k, b in model.named_buffers()}
    return float(loss.detach()), grads, stats


def _remat_pair(arch, encoder, dtype=torch.float32):
    base = init_model(create_model(arch, encoder, classes=2, dtype=dtype), seed=1)
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.random((2, 64, 64, 2)) > 0.6).astype(np.float32))
    plain = _step_grads(copy.deepcopy(base), imgs, masks)
    with_remat = copy.deepcopy(base)
    remat_mod.set_block_remat(with_remat, True)
    return plain, _step_grads(with_remat, imgs, masks), (base, imgs, masks)


def _assert_stats_equal(got, want):
    for k in want:
        np.testing.assert_allclose(got[k].double().numpy(), want[k].double().numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize('arch,encoder', FAMILIES)
def test_remat_step_equals_plain_step(arch, encoder):
    (loss, grads, stats), (rloss, rgrads, rstats), _ = _remat_pair(arch, encoder)
    assert abs(loss - rloss) <= 1e-6 * abs(loss)
    for k in grads:
        np.testing.assert_allclose(rgrads[k].numpy(), grads[k].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(grads[k].abs().max()), err_msg=k)
    _assert_stats_equal(rstats, stats)


def test_remat_control_doubled_statistics_update_fails(monkeypatch):
    """Without the recomputation guard every checkpointed BatchNorm moves
    its statistics twice in a step, which the statistics check catches."""
    monkeypatch.setattr('octseg_torch.models.common.recomputing', lambda: False)
    (_loss, _grads, stats), (_rl, _rg, rstats), _ = _remat_pair('Unet', 'resnet18')
    with pytest.raises(AssertionError):
        _assert_stats_equal(rstats, stats)


def test_remat_bf16_step_equals_plain_bf16_step():
    (loss, grads, stats), (rloss, rgrads, rstats), _ = _remat_pair(
        'LinkNet', 'efficientnet-b0', torch.bfloat16)
    assert loss == rloss
    for k in grads:
        assert torch.equal(rgrads[k], grads[k]), k
    _assert_stats_equal(rstats, stats)


def test_remat_keeps_parameter_names_and_skips_under_no_grad():
    plain = create_model('LinkNet', 'efficientnet-b0', classes=2)
    rem = create_model('LinkNet', 'efficientnet-b0', classes=2, remat=True)
    assert list(plain.state_dict()) == list(rem.state_dict())
    rem.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 3, 64, 64)).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(plain.eval()(x), rem.eval()(x))
