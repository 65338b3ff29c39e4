"""octseg_torch's ``get_model_info`` against octseg's, on the CPU.

- Parameters, all 144 pairs of SUPPORTED_ARCHITECTURES x SUPPORTED_ENCODERS:
  the port's count (its model's parameters, built on the meta device) equals
  octseg's flax ``params`` count exactly. octseg's count is taken with its
  own ``jax.eval_shape`` of ``model.init``, over its own encode/decode split
  (octseg/models/base.py): the encoder's parameters (the same at output
  stride 32, 16 and 8, which only changes strides into dilations) plus the
  decoder's and head's, traced from the encoder's feature shapes. A decoder
  sees only its features, so its count is traced once per architecture and
  distinct encoder channel tuple (11 tuples for the 16 encoders). The
  traces run in four spawned processes while this one builds the port's
  models; together that keeps the check near a fifth of tracing all 144
  models in turn.
- FLOPs at 64 px on a few pairs, both packages' ``model_info``: the port's
  count (``FlopCounterMode``: every tap of every convolution and matmul) lies
  within FLOPS_BAND of octseg's XLA ``cost_analysis`` count. XLA counts only
  the taps that fall inside the input, so at 64 px, where the deepest maps
  are 2x2 (and PSPNet's pooled branches 1x1), it counts fewer convolution
  FLOPs than the port, and then adds the elementwise work. The rule is held
  exactly on one convolution: the port's count times the share of in-bounds
  taps is XLA's count.
- ``main`` reads configs/get_model_info.yaml; ``bytes_accessed`` is None.
"""

import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from octseg.models import create_model as jax_create_model
from octseg.models.get_model_info import model_info as jax_model_info
from octseg_torch.core.config import load_config
from octseg_torch.models import SUPPORTED_ARCHITECTURES, SUPPORTED_ENCODERS, create_model
from octseg_torch.models import get_model_info
from octseg_torch.models.encoders import encoder_out_channels
from tests.torch_threads import torch_threads_share  # noqa: F401

# port / octseg at 64 px: the band stated before measuring was 0.75-1.0
# (PERF.md, Findings); it missed, since XLA skips padded taps. Measured on these
# pairs: 1.0019 (DeepLabV3Plus) to 2.2755 (PSPNet).
FLOPS_BAND = (0.95, 2.5)
FLOPS_PAIRS = [('Unet', 'resnet18'), ('FPN', 'efficientnet-b0'), ('PSPNet', 'resnet34'),
               ('DeepLabV3Plus', 'timm-regnetx_002')]
CLASSES = 4
WORKERS = 4
# the encoders, costliest trace first, dealt out to the workers in turn
HEAVY_FIRST = ['efficientnet-b7', 'efficientnet-b6', 'efficientnet-b5', 'efficientnet-b4',
               'resnet152', 'timm-regnety_120', 'efficientnet-b3', 'resnet101',
               'efficientnet-b2', 'efficientnet-b1', 'efficientnet-b0', 'timm-regnetx_064',
               'resnet50', 'resnet34', 'timm-regnetx_002', 'resnet18']
RNGS = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)}


def _jax_params(model, method, x) -> int:
    shapes = jax.eval_shape(functools.partial(model.init, train=False, method=method), RNGS, x)
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes['params']))


def _port_params(arch, encoder) -> int:
    with torch.device('meta'):
        model = create_model(arch, encoder, classes=CLASSES)
    return sum(p.numel() for p in model.parameters())


def _output_stride(arch):
    return {'PAN': 16, 'DeepLabV3': 8, 'DeepLabV3Plus': 16}.get(arch, 32)


def _feature_shapes(encoder, output_stride, size):
    """(N, H, W, C) of octseg's six pyramid levels at ``size`` px."""
    shapes = []
    for level, c in enumerate(encoder_out_channels(encoder)):
        s = size // min(2 ** level, output_stride)
        shapes.append(jax.ShapeDtypeStruct((1, s, s, c), jnp.float32))
    return shapes


def _jax_counts(jobs):
    """octseg's counts for ('encode', encoder) and ('decode', arch, encoder)
    jobs (run in a spawned process)."""
    out = {}
    for job in jobs:
        if job[0] == 'encode':
            model = jax_create_model('Unet', job[1], classes=CLASSES)
            out[job] = _jax_params(model, 'encode', jnp.zeros((1, 64, 64, 3), jnp.float32))
        else:
            _kind, arch, encoder = job
            size = 128 if arch == 'PAN' else 64   # PAN's pyramid pools the deepest map by 4
            model = jax_create_model(arch, encoder, classes=CLASSES)
            out[job] = _jax_params(model, 'decode',
                                   _feature_shapes(encoder, _output_stride(arch), size))
    return out


def _representatives():
    """One encoder per distinct channel tuple."""
    seen = {}
    for encoder in SUPPORTED_ENCODERS:
        seen.setdefault(tuple(encoder_out_channels(encoder)), encoder)
    return seen


@pytest.fixture(scope='module')
def jax_counts():
    """Futures of octseg's encoder counts by name and decoder-and-head
    counts by (architecture, channel tuple)."""
    jobs = [('encode', e) for e in HEAVY_FIRST]
    jobs += [('decode', arch, e) for arch in SUPPORTED_ARCHITECTURES
             for e in _representatives().values()]
    groups = [jobs[i::WORKERS] for i in range(WORKERS)]
    with ProcessPoolExecutor(WORKERS, mp_context=multiprocessing.get_context('spawn')) as pool:
        futures = [pool.submit(_jax_counts, g) for g in groups]
        cache = {}

        def count(job):
            if job not in cache:
                for fut in futures:
                    cache.update(fut.result())
            return cache[job]

        yield count


def test_encoder_parameters_do_not_depend_on_the_output_stride():
    from octseg_torch.models.encoders import create_encoder
    for encoder in SUPPORTED_ENCODERS:
        counts = set()
        for stride in (32, 16, 8):
            with torch.device('meta'):
                counts.add(sum(p.numel() for p in create_encoder(encoder, stride).parameters()))
        assert len(counts) == 1, encoder


@pytest.mark.parametrize('arch,encoder', FLOPS_PAIRS)
def test_flops_within_the_band_of_octsegs(arch, encoder, jax_counts):
    # requesting jax_counts starts octseg's traces for the parameter test
    # below, which then overlap these tests
    want = jax_model_info(arch, encoder, 64, CLASSES)
    got = get_model_info.model_info(arch, encoder, 64, CLASSES, device='cpu')
    assert got['params'] == want['params'] and got['params_m'] == want['params_m']
    ratio = got['flops'] / want['flops']
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    assert got['gflops'] == round(got['flops'] / 1e9, 2) and got['bytes_accessed'] is None
    assert {k: got[k] for k in ('architecture', 'encoder', 'input_size')} == \
        {'architecture': arch, 'encoder': encoder, 'input_size': 64}


def test_xla_counts_the_in_bounds_taps_of_a_convolution():
    x = jnp.zeros((1, 16, 16, 8), jnp.float32)
    w = jnp.zeros((3, 3, 8, 32), jnp.float32)
    xla = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), 'SAME', dimension_numbers=('NHWC', 'HWIO', 'NHWC'))).lower(
        x, w).compile().cost_analysis()['flops']
    counter = FlopCounterMode(display=False)
    with counter:
        torch.nn.functional.conv2d(torch.zeros(1, 8, 16, 16), torch.zeros(32, 8, 3, 3),
                                   padding=1)
    in_bounds = (3 * 16 - 2) ** 2 / (3 * 16) ** 2   # per axis: 16 rows x 3 taps, 2 padded
    assert counter.get_total_flops() == 2 * 16 * 16 * 32 * 9 * 8
    assert xla == counter.get_total_flops() * in_bounds


def test_main_reads_its_config():
    cfg = load_config('get_model_info', ['encoder=resnet18', 'input_size=64', 'device=cpu'])
    info = get_model_info.main(cfg)
    assert (info['architecture'], info['encoder'], info['input_size']) == ('Unet', 'resnet18', 64)
    assert info['params'] == _port_params('Unet', 'resnet18')


@pytest.mark.parametrize('arch', SUPPORTED_ARCHITECTURES)
def test_parameter_count_equals_octsegs(arch, jax_counts):
    ports = {encoder: _port_params(arch, encoder) for encoder in SUPPORTED_ENCODERS}
    representatives = _representatives()
    for encoder in SUPPORTED_ENCODERS:
        rep = representatives[tuple(encoder_out_channels(encoder))]
        want = jax_counts(('encode', encoder)) + jax_counts(('decode', arch, rep))
        assert ports[encoder] == want, f'{arch}/{encoder}'
