"""octseg_torch's training pieces against the JAX package's, on the CPU.

The loss and metrics, each optimizer against its optax chain, BatchNorm's
running statistics against flax, and Unet/resnet18 from the same variables
(carried over by the weights bridge): the first step's gradients, then
three train steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.models import create_model as jax_create_model
from octseg.train import checkpoint as jax_ckpt
from octseg.train.losses import dice_loss_from_logits as jax_dice
from octseg.train.metrics import compute_metrics as jax_metrics
from octseg.train.state import TrainState as JaxTrainState
from octseg.train.state import make_optimizer as jax_optimizer
from octseg.train.train import _loss_and_metrics as jax_loss_and_metrics
from octseg.train.train import make_train_step as jax_train_step
from octseg_torch.models import create_model
from octseg_torch.models.common import BatchNorm2d
from octseg_torch.models.convert import state_dict_to_variables
from octseg_torch.train import checkpoint as ckpt
from octseg_torch.train.losses import dice_loss_from_logits
from octseg_torch.train.metrics import compute_metrics
from octseg_torch.train.state import TrainState, make_optimizer
from octseg_torch.train.train import _loss_and_logits, make_train_step

CLASSES = 4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 20, 24, CLASSES)).astype(np.float32)
    targets = (rng.random((3, 20, 24, CLASSES)) > 0.6).astype(np.float32)
    targets[:, :, :, 3] = 0   # a class absent from the batch
    want = float(jax_dice(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(dice_loss_from_logits(_nchw(logits), _nchw(targets)))
    assert abs(got - want) <= 1e-6
    pred = (logits > 0).astype(np.float32)
    want_m = jax_metrics(jnp.asarray(pred), jnp.asarray(targets), jnp.float32(want))
    got_m = compute_metrics(_nchw(pred), _nchw(targets), torch.tensor(got))
    assert set(got_m) == set(want_m)
    for name in want_m:
        np.testing.assert_allclose(got_m[name].numpy(), np.asarray(want_m[name]),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('name', ['SGD', 'RMSprop', 'RAdam', 'Adam', 'SAdam'])
@pytest.mark.parametrize('weight_decay', [0.0, 1e-4])
def test_optimizer_matches_its_optax_chain(name, weight_decay):
    """Six steps (RAdam rectifies from step 6 on; steps 1-5 take its plain
    momentum branch), against octseg's chain jitted as the train step jits it."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = jax_optimizer(name, 1e-3, weight_decay)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    opt = make_optimizer(name, 1e-3, weight_decay)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for _ in range(6):
        grads = [(rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
                 for s in shapes]
        u, jstate = update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = [p + v for p, v in zip(jp, u)]
        opt.step(tp, [torch.from_numpy(g) for g in grads], tstate)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)


@pytest.fixture(scope='module')
def jax_model_dir(tmp_path_factory):
    """A Unet/resnet18 model dir with flax-initialized weights (BatchNorm
    statistics moved off their identity so eval mode is exercised)."""
    path = str(tmp_path_factory.mktemp('init') / 'm')
    jax_ckpt.initialize_model_dir(path, ['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum'],
                                  'Unet', 'resnet18', input_size=64, seed=3, init_size=32)
    raw = jax_ckpt.load_weights(os.path.join(path, 'weights.ckpt'))
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda v: np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v))
                         + rng.normal(0, 0.1, np.shape(v)), raw['batch_stats'])
    stats = jax.tree.map(lambda v: np.abs(v).astype(np.float32), stats)
    jax_ckpt.save_weights(os.path.join(path, 'weights.ckpt'), raw['params'], stats)
    return path


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_model(model_dir):
    model = create_model('Unet', 'resnet18', classes=CLASSES)
    ckpt.restore_weights_into(model, os.path.join(model_dir, 'weights.ckpt'), 'Unet', 'resnet18')
    return model


@pytest.mark.parametrize('shape', [(4, 16, 2, 2), (3, 8, 17, 9)])
def test_batchnorm_layer_matches_flax(shape):
    """One train-mode forward of the layer: output, and running mean and
    variance moved by 0.1 towards the batch mean and the biased batch
    variance, as flax's BatchNorm(momentum=0.9) moves them."""
    from flax import linen as nn

    n, c, h, w = shape
    rng = np.random.default_rng(c)
    x = (rng.normal(2.0, 3.0, (n, h, w, c))).astype(np.float32)
    scale, bias = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    mean0, var0 = rng.normal(0, 1, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean0, 'var': var0}}
    want, mutated = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5).apply(
        variables, jnp.asarray(x), mutable=['batch_stats'])
    bn = BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        got = bn(_nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for ours, key in ((bn.running_mean, 'mean'), (bn.running_var, 'var')):
        np.testing.assert_allclose(ours.numpy(), np.asarray(mutated['batch_stats'][key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_batchnorm_running_stats_of_the_model_match_flax(jax_model_dir):
    """One train-mode forward of Unet/resnet18: every layer's running
    statistics as flax's. The two packages' convolutions round differently,
    and the difference grows through the 20 layers, so the deep statistics
    are held to 1e-5 relative (the layer itself to 1e-6, above)."""
    x = np.random.default_rng(4).normal(0, 50, (4, 64, 64, 3)).astype(np.float32)
    variables = jax_ckpt.load_weights(os.path.join(jax_model_dir, 'weights.ckpt'))
    model = jax_create_model('Unet', 'resnet18', classes=CLASSES)
    _, mutated = model.apply(variables, jnp.asarray(x), train=True, mutable=['batch_stats'])
    port = _port_model(jax_model_dir).train()
    with torch.no_grad():
        port(_nchw(x))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    got = _flat(state_dict_to_variables(sd, 'Unet', 'resnet18')['batch_stats'])
    want = _flat(mutated['batch_stats'])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(port.encoder.bn1.num_batches_tracked) == 1


def test_eval_mode_keeps_running_stats(jax_model_dir):
    port = _port_model(jax_model_dir).eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        port(torch.zeros(2, 3, 32, 32))
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())


def _leaf_gaps(got, want):
    """Per leaf of a flat tree: |got - want| / |want| in the L2 norm."""
    return {k: float(np.linalg.norm(got[k].astype(np.float64) - want[k])
                     / np.linalg.norm(want[k].astype(np.float64))) for k in want}


def _port_gradients(model, imgs, masks):
    """Loss and the flat flax tree of the gradients of one train-mode step."""
    model.train()
    loss, _, _ = _loss_and_logits(model, torch.from_numpy(imgs), torch.from_numpy(masks))
    loss.backward()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    sd.update({k: p.grad.numpy() for k, p in model.named_parameters()})
    return loss.item(), _flat(state_dict_to_variables(sd, 'Unet', 'resnet18')['params'])


def _detach_batch_stats(bn):
    """A BatchNorm bug for the control: the forward is unchanged, but no
    gradient flows through the batch mean and variance."""
    def forward(x):
        var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), unbiased=False)
        shape = (1, -1, 1, 1)
        return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
                * bn.weight.view(shape) + bn.bias.view(shape))
    bn.forward = forward


# worst leaf of |g_port - g_octseg| / |g_octseg| at the first step: 1.68e-2
# measured; the controls below read 0.43 and 0.64
GRAD_GAP = 5e-2


def test_first_step_gradients_match_jax(jax_model_dir):
    """The gradient of every parameter leaf at the first train step, held
    as a relative L2 gap, the worst leaf within GRAD_GAP of octseg's. Two
    controls with the same forward must fail it: one decoder skip
    connection detached, and one BatchNorm layer's batch statistics
    detached."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 255, (4, 64, 64, 3)).astype(np.float32)
    masks = (rng.random((4, 64, 64, CLASSES)) > 0.7).astype(np.float32)
    variables = jax_ckpt.load_weights(os.path.join(jax_model_dir, 'weights.ckpt'))
    model = jax_create_model('Unet', 'resnet18', classes=CLASSES)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jax_loss_and_metrics(
        model, p, variables['batch_stats'], jnp.asarray(imgs), jnp.asarray(masks), True,
        jax.random.PRNGKey(0))[0]))(variables['params'])
    want = _flat(want)

    loss, got = _port_gradients(_port_model(jax_model_dir), imgs, masks)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert set(got) == set(want)
    assert max(_leaf_gaps(got, want).values()) <= GRAD_GAP

    skipless = _port_model(jax_model_dir)
    skipless.decoder.blocks[1].register_forward_pre_hook(lambda _, a: (a[0], a[1].detach()))
    frozen = _port_model(jax_model_dir)
    _detach_batch_stats(frozen.encoder.layer4[1].bn2)
    for control in (skipless, frozen):
        control_loss, bad = _port_gradients(control, imgs, masks)
        assert control_loss == loss
        assert max(_leaf_gaps(bad, want).values()) > GRAD_GAP


def _keep_gradients(state):
    """A train-loop bug for the control: the gradients are never cleared,
    so each step adds its gradient to the ones before."""
    def apply_gradients():
        params = state.params_of(state.model)
        state.tx.step(params, [p.grad for p in params], state.opt_state)
        state.step += 1
    state.apply_gradients = apply_gradients


# worst leaf of |update_port - update_octseg| / |update_octseg| after three
# SGD steps: 0.062 measured; the control reads 1.45
UPDATE_GAP = 0.2


def test_three_train_steps_match_jax(jax_model_dir):
    """Three SGD steps at lr 1e-2 from the same variables, no augmentation:
    per-step losses within 1e-5 relative; each parameter leaf's update
    (final minus initial) within UPDATE_GAP relative of octseg's, and every
    parameter within 1e-4; BatchNorm statistics within 1e-4 relative to
    1 + |value|. A loop that never clears the gradients must fail.

    SGD, because its update is the gradient: a wrong gradient moves the
    parameters by as much. Adam's first steps move each entry by about lr
    whatever its gradient, so entries whose float32 gradients differ in
    the noise step apart and move the next steps' gradients: after three
    Adam steps at lr 1e-3 under half the entries agree within 1e-4, between
    the card and the CPU (chip_smoke.py prints the share) as between the
    two packages. Adam's formulas are held against optax above, the
    gradients in the test before."""
    lr, steps = 1e-2, 3
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 255, (steps, 4, 64, 64, 3)).astype(np.float32)
    masks = (rng.random((steps, 4, 64, 64, CLASSES)) > 0.7).astype(np.float32)

    variables = jax_ckpt.load_weights(os.path.join(jax_model_dir, 'weights.ckpt'))
    model = jax_create_model('Unet', 'resnet18', classes=CLASSES)
    jstate = JaxTrainState.create(variables['params'], variables['batch_stats'],
                                  jax_optimizer('SGD', lr))
    jstep = jax.jit(jax_train_step(model, False))
    want_losses = []
    for k in range(steps):
        jstate, m = jstep(jstate, jnp.asarray(imgs[k]), jnp.asarray(masks[k]),
                          jax.random.PRNGKey(k))
        want_losses.append(float(m['loss']))
    start = _flat(variables['params'])
    want_update = {k: np.asarray(v) - start[k] for k, v in _flat(jstate.params).items()}

    def port_run(control=False):
        port = _port_model(jax_model_dir)
        state = TrainState.create(port, make_optimizer('SGD', lr))
        if control:
            _keep_gradients(state)
        step = make_train_step(use_augmentation=False)
        losses = [float(step(state, torch.from_numpy(imgs[k]), torch.from_numpy(masks[k]),
                             torch.Generator())['loss']) for k in range(steps)]
        sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
        got = state_dict_to_variables(sd, 'Unet', 'resnet18')
        update = {k: v - start[k] for k, v in _flat(got['params']).items()}
        return state, np.array(losses), update, _flat(got['batch_stats'])

    state, losses, update, stats = port_run()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert state.step == steps and state.opt_state['count'] == steps
    assert set(update) == set(want_update)
    assert max(_leaf_gaps(update, want_update).values()) <= UPDATE_GAP
    assert max(np.abs(update[k] - want_update[k]).max() for k in update) <= 1e-4
    want_s = _flat(jstate.batch_stats)
    assert max((np.abs(stats[k] - want_s[k]) / (1 + np.abs(want_s[k]))).max()
               for k in want_s) <= 1e-4

    _, bad_losses, bad_update, _ = port_run(control=True)
    assert abs(bad_losses[-1] - want_losses[-1]) > 1e-5 * abs(want_losses[-1])
    assert max(_leaf_gaps(bad_update, want_update).values()) > UPDATE_GAP


@pytest.mark.parametrize('layout', ['torchvision', 'smp model', 'lightning'])
def test_pretrained_encoder_loads_as_in_jax(tmp_path, layout):
    """encoder_weights: a local torch file (torchvision's resnet with its fc
    head and no num_batches_tracked, a full SMP model, or a Lightning
    checkpoint) loads into the encoder as octseg's load_pretrained_encoder
    loads it into its variables."""
    from octseg.models.convert_torch import load_pretrained_encoder as jax_load

    donor = create_model('Unet', 'resnet18', classes=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for v in donor.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=gen))
    enc = {k: v for k, v in donor.encoder.state_dict().items()
           if not k.endswith('num_batches_tracked')}
    if layout == 'torchvision':
        sd = dict(enc, **{'fc.weight': torch.zeros(1000, 512), 'fc.bias': torch.zeros(1000)})
    elif layout == 'smp model':
        sd = donor.state_dict()
    else:
        sd = {'state_dict': {f'model.encoder.{k}': v for k, v in enc.items()}}
    path = str(tmp_path / 'enc.pth')
    torch.save(sd, path)

    port = create_model('Unet', 'resnet18', classes=CLASSES)
    ckpt.load_pretrained_encoder(port, path)
    for k, v in enc.items():
        assert torch.equal(port.encoder.state_dict()[k], v), k

    fresh = {k: v.numpy() for k, v in create_model('Unet', 'resnet18',
                                                    classes=CLASSES).state_dict().items()}
    want = jax_load(state_dict_to_variables(fresh, 'Unet', 'resnet18'), path, 'resnet18')
    got = state_dict_to_variables({k: v.numpy() for k, v in port.state_dict().items()},
                                  'Unet', 'resnet18')
    for part in ('params', 'batch_stats'):
        a, b = _flat(got[part]['encoder']), _flat(want[part]['encoder'])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bad = str(tmp_path / 'bad.pth')
    torch.save({'conv1.weight': torch.zeros(3, 3, 3, 3)}, bad)
    with pytest.raises(ValueError, match='does not match'):
        ckpt.load_pretrained_encoder(port, bad)


@pytest.mark.parametrize('arch,encoder,tail', [
    ('LinkNet', 'efficientnet-b0', {'_conv_head.weight': (1280, 320, 1, 1),
                                    '_bn1.weight': (1280,), '_bn1.bias': (1280,),
                                    '_bn1.running_mean': (1280,), '_bn1.running_var': (1280,),
                                    '_fc.weight': (1000, 1280), '_fc.bias': (1000,)}),
    ('Unet', 'timm-regnetx_002', {'head.fc.weight': (1000, 368), 'head.fc.bias': (1000,)}),
])
def test_pretrained_encoder_drops_classifier_tails_as_jax(tmp_path, arch, encoder, tail):
    """An efficientnet-pytorch or timm encoder file carries its classifier
    tail; both packages drop it and load the rest."""
    from octseg.models.convert_torch import load_pretrained_encoder as jax_load

    donor = create_model(arch, encoder, classes=1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for v in donor.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=gen))
    enc = dict(donor.encoder.state_dict())
    sd = dict(enc, **{k: torch.randn(shape, generator=gen) for k, shape in tail.items()})
    path = str(tmp_path / 'enc.pth')
    torch.save(sd, path)

    port = create_model(arch, encoder, classes=CLASSES)
    ckpt.load_pretrained_encoder(port, path)
    for k, v in enc.items():
        assert torch.equal(port.encoder.state_dict()[k], v), k

    fresh = {k: v.numpy() for k, v in create_model(arch, encoder,
                                                    classes=CLASSES).state_dict().items()}
    want = jax_load(state_dict_to_variables(fresh, arch, encoder), path, encoder)
    got = state_dict_to_variables({k: v.numpy() for k, v in port.state_dict().items()},
                                  arch, encoder)
    for part in ('params', 'batch_stats'):
        a, b = _flat(got[part]['encoder']), _flat(want[part]['encoder'])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
