"""The rest of the model zoo in train mode, octseg_torch against the JAX
package on the CPU: one step of FPN, PSPNet and MAnet (encoder at output
stride 32) over resnet18 at 64 px, from octseg's own
initialization at a seed with its BatchNorm statistics moved off the
identity (as tests/test_torch_train.py's fixture moves them), carried over
by the weights bridge.

- Every BatchNorm's running statistics within 1e-4 relative to
  1 + |value|, and the first step's gradients leaf by leaf within GRAD_GAP:
  the bounds tests/test_torch_train.py holds Unet's train steps to (flax
  computes the variance as E[x^2] - E[x]^2, which cancels on the first
  layer's large means of a step from 0..255 images: 1.9e-5 relative here).
- Some leaves are ill-conditioned in float32: MAnet's SE gate biases at
  full resolution sum terms of both signs to a norm of 6e-6 (others 1e-3),
  and octseg's own gradient there moves by 0.09 when only the order of the
  frames in the batch changes. So each leaf's yardstick is the larger of
  GRAD_GAP and NOISE_FACTOR times that reordering gap of octseg's, computed
  in the test (the port read 0.25 on that leaf).
- Four frames, as that file's steps: the BatchNorms over pooled 1x1 maps
  (PAN's GAU gates, DeepLab's pooling branch) see one value per frame, and
  over two values the variance is ill-conditioned.
- The bias of a conv that feeds a train-mode BatchNorm in the same module
  (PAN's ConvBnRelu) has a gradient of exactly 0: the BatchNorm subtracts
  it with the batch mean. Both sides hold rounding noise there (about 1e-10
  against a largest leaf of 1), so those leaves are held to ZERO_GRAD times
  the largest leaf's norm instead.
- Dropout draws differ between the packages, so it is off on both sides:
  flax's ``nn.Dropout`` is stubbed to the identity here (monkeypatch; no
  file of octseg changes) and the port's dropouts get p = 0. The control
  keeps the port's dropout and must fail the gradient bound.

bf16 with remat on: a bf16 backward is its own rounding of the fp32 one,
and a large one: here octseg's bf16 gradient lies 0.034 (PSPNet) to 0.82
(MAnet) from its fp32 gradient in relative L2 over all leaves (the port's
0.040 to 0.96). So, as tests/test_torch_bf16.py holds bf16 logits, the
port's bf16 step with remat is held to twice octseg's own bf16 distance
from octseg's fp32 step over all leaves, and not 0; its loss within
BF16_LOSS relative of octseg's bf16 loss, tests/test_torch_bf16.py's bound
for a bf16 step (measured 1.9e-5 to 7.0e-4). Parameters and gradients stay
float32.

``check_train_step`` and ``check_bf16_remat_step`` also serve tests/test_torch_zoo_train_dilated.py
(PAN, DeepLabV3 and DeepLabV3Plus over dilated encoders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from octseg.models import create_model as jax_create_model
from octseg.train.train import _loss_and_metrics as jax_loss_and_metrics
from octseg_torch.models import create_model
from octseg_torch.models.common import _Dropout, set_dropout_generator
from octseg_torch.models.convert import state_dict_to_variables, variables_to_state_dict
from octseg_torch.train.train import _loss_and_logits
from tests.test_torch_train import GRAD_GAP
from tests.test_torch_zoo import CLASSES, _size
from tests.test_torch_zoo_convert import one_thread  # noqa: F401 (a fixture)
from tests.torch_threads import torch_threads_share  # noqa: F401

FRAMES = 4
ZERO_GRAD = 1e-6
STATS_GAP = 1e-4
NOISE_FACTOR = 4.0
BF16_LOSS = 1e-3


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _worst_ratio(got, want, reordered):
    """The worst leaf's |got - want| / |want| (L2) over its yardstick, the
    larger of GRAD_GAP and NOISE_FACTOR times |reordered - want| / |want|;
    above 1 fails. A leaf whose gradient is 0 in octseg (PSPNet's unused
    deep stages) must be 0 here; a conv bias beside a BatchNorm must be
    below ZERO_GRAD times the largest leaf's norm on both sides."""
    scale = max(np.linalg.norm(w) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        beside_bn = k.replace("['Conv_0']['bias']", "['BatchNorm_0']['scale']")
        if beside_bn != k and beside_bn in want:
            ratio = 0.0 if max(np.linalg.norm(w), np.linalg.norm(got[k])) <= ZERO_GRAD * scale \
                else np.inf
        else:
            w64 = w.astype(np.float64)
            norm = np.linalg.norm(w64)
            gap = np.linalg.norm(got[k] - w64)
            noise = np.linalg.norm(reordered[k] - w64)
            if norm > 0:
                gap, noise = gap / norm, noise / norm
            ratio = gap / max(GRAD_GAP, NOISE_FACTOR * noise)
        worst = max(worst, ratio)
    return worst


def _port_step(arch, variables, imgs, masks, keep_dropout=False, dtype=torch.float32,
               remat=False):
    """(loss, flat gradients, flat BatchNorm statistics) of one train-mode
    step of the port from ``variables``."""
    model = create_model(arch, 'resnet18', classes=CLASSES, dtype=dtype, remat=remat)
    sd = variables_to_state_dict(variables, arch, 'resnet18')
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    if keep_dropout:
        set_dropout_generator(model, torch.Generator().manual_seed(0))
    else:
        for mod in model.modules():
            if isinstance(mod, _Dropout):
                mod.p = 0.0
    model.train()
    loss, _, _ = _loss_and_logits(model, torch.from_numpy(imgs), torch.from_numpy(masks))
    loss.backward()
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    # an unused parameter (PSPNet's deep stages) has no gradient: flax's is 0
    grads = dict(state, **{k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                           else p.grad.numpy() for k, p in model.named_parameters()})
    got = state_dict_to_variables(grads, arch, 'resnet18')
    stats = state_dict_to_variables(state, arch, 'resnet18')['batch_stats']
    return loss.item(), _flat(got['params']), _flat(stats)


def _stub_flax_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, '__call__',
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def _loss_and_grad(fm, batch_stats):
    key = jax.random.PRNGKey(8)
    return jax.jit(jax.value_and_grad(
        lambda p, x, y: jax_loss_and_metrics(fm, p, batch_stats, x, y, True, key),
        has_aux=True))


@functools.lru_cache(maxsize=None)
def _octseg_step(arch):
    """octseg's fp32 step of ``arch`` over resnet18, flax's dropout stubbed
    (the caller stubs it): (variables, imgs, masks, loss, flat gradients,
    flat statistics, flat gradients of the reordered batch)."""
    size = _size(arch)
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 255, (FRAMES, size, size, 3)).astype(np.float32)
    masks = (rng.random((FRAMES, size, size, CLASSES)) > 0.7).astype(np.float32)
    fm = jax_create_model(arch, 'resnet18', classes=CLASSES)
    key = jax.random.PRNGKey(8)
    variables = jax.jit(lambda x: fm.init({'params': key, 'dropout': key}, x))(
        jnp.asarray(imgs[:1]))
    variables = {'params': variables['params'], 'batch_stats': jax.tree.map(
        lambda v: np.abs(np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v))
                         + rng.normal(0, 0.1, np.shape(v))).astype(np.float32),
        variables['batch_stats'])}
    step = _loss_and_grad(fm, variables['batch_stats'])
    (want_loss, (_, want_stats)), want = step(variables['params'], jnp.asarray(imgs),
                                              jnp.asarray(masks))
    order = [2, 0, 3, 1]
    _, reordered = step(variables['params'], jnp.asarray(imgs[order]),
                        jnp.asarray(masks[order]))
    return (variables, imgs, masks, float(want_loss), _flat(want), _flat(want_stats),
            _flat(reordered))


def check_train_step(arch, monkeypatch):
    """One train step of ``arch`` over resnet18, port against octseg, as
    the module docstring says."""
    _stub_flax_dropout(monkeypatch)
    variables, imgs, masks, want_loss, want, want_stats, reordered = _octseg_step(arch)

    loss, got, stats = _port_step(arch, variables, imgs, masks)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert set(stats) == set(want_stats)
    assert max((np.abs(stats[k] - want_stats[k]) / (1 + np.abs(want_stats[k]))).max()
               for k in want_stats) <= STATS_GAP
    assert set(got) == set(want)
    assert _worst_ratio(got, want, reordered) <= 1.0

    if arch in ('FPN', 'PSPNet', 'DeepLabV3', 'DeepLabV3Plus'):
        _, bad, _ = _port_step(arch, variables, imgs, masks, keep_dropout=True)
        assert _worst_ratio(bad, want, reordered) > 1.0


def _bf16_gap(got, want):
    """|got - want| / |want| in L2 over all leaves."""
    num = sum(np.sum((got[k].astype(np.float64) - want[k]) ** 2) for k in want)
    den = sum(np.sum(want[k].astype(np.float64) ** 2) for k in want)
    return float(np.sqrt(num / den))


def check_bf16_remat_step(arch, monkeypatch):
    """The port's bf16 step with remat on against octseg's fp32 step, held
    to twice octseg's own bf16 distance from it, as the module docstring
    says."""
    _stub_flax_dropout(monkeypatch)
    variables, imgs, masks, loss32, grads32, _, _ = _octseg_step(arch)
    fm16 = jax_create_model(arch, 'resnet18', classes=CLASSES, dtype=jnp.bfloat16)
    (loss16, _), grads16 = _loss_and_grad(fm16, variables['batch_stats'])(
        variables['params'], jnp.asarray(imgs), jnp.asarray(masks))
    loss16, grads16 = float(loss16), _flat(grads16)
    loss, grads, _ = _port_step(arch, variables, imgs, masks, dtype=torch.bfloat16, remat=True)
    assert set(grads) == set(grads32)
    jax_gap, port_gap = _bf16_gap(grads16, grads32), _bf16_gap(grads, grads32)
    assert port_gap > 0, 'a bf16 step computed in fp32'
    assert port_gap <= 2 * jax_gap, (
        f'{arch}: port bf16 gradient {port_gap:.4g} from fp32, octseg {jax_gap:.4g}')
    assert abs(loss - loss16) <= BF16_LOSS * abs(loss16), (loss, loss16, loss32)


@pytest.mark.parametrize('arch', ['FPN', 'PSPNet', 'MAnet'])
def test_zoo_train_step_matches_jax(arch, monkeypatch):
    check_train_step(arch, monkeypatch)


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('arch', ['FPN', 'PSPNet', 'MAnet'])
def test_zoo_bf16_remat_step_as_close_to_fp32_as_octsegs_bf16(arch, monkeypatch):
    check_bf16_remat_step(arch, monkeypatch)
