"""octseg_torch.ops.quantize (int8 inference) against octseg.ops.quantize.

- Quantization: the activations' int8 values and scale, and the weights'
  int8 values and per-channel scales, are octseg's bit for bit (octseg's
  own int8 operands are caught where it hands them to
  ``lax.conv_general_dilated``), on float32 and bfloat16, on values placed
  on exact .5 boundaries of ``x * 127 / sa`` (round half to even) and on
  all-zero tensors (``sa`` = 1e-8).
- The convolution: the plain version's int32 sums equal XLA's
  ``conv_general_dilated(..., preferred_element_type=int32)`` on octseg's
  operands, and a port convolution's int8 output equals octseg's
  ``quantized_conv`` bit for bit, over strides 1 and 2, 1x1 and 3x3,
  dilation 2, XLA SAME with asymmetric padding, channels 40 and 56, a
  channel count the kernels pad (12), float32 and bfloat16.
- Eligibility: the port's int8 convolutions, (k, Cin, Cout, stride) as a
  multiset over one forward, are octseg's interceptor's for the three
  winners at full width (the port on the meta device, octseg under
  ``jax.eval_shape``): 114, 159 and 41.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from octseg.models import create_model as jax_create_model
from octseg.ops import quantize as jq
from octseg_torch.models import create_model
from octseg_torch.models.common import Conv2d, Conv2dSame, same_padding
from octseg_torch.ops import quantize
from octseg_torch.ops.kernels.int8_conv import int32_sums_plain
from octseg_torch.ops.kernels.quantize import quantize_activation
from tests.torch_threads import torch_threads_share  # noqa: F401

WINNERS = [('UnetPlusPlus', 'resnet101', 512, 1, 114),
           ('LinkNet', 'efficientnet-b7', 896, 2, 159),
           ('Unet', 'timm-regnetx_064', 896, 1, 41)]


def _octseg_operands(monkeypatch):
    """A list that collects (xq, wq) of each conv octseg's int8 path runs."""
    seen = []
    conv = jax.lax.conv_general_dilated

    def recording(lhs, rhs, *args, **kwargs):
        seen.append((np.asarray(lhs), np.asarray(rhs)))
        return conv(lhs, rhs, *args, **kwargs)

    monkeypatch.setattr(jax.lax, 'conv_general_dilated', recording)
    return seen


def _pair(cin, cout, k, stride=1, dilation=1, padding=1, bias=True, bf16=False, seed=0):
    """(flax nn.Conv, its kernel, its bias, the port's module with the same
    weights) for one geometry; ``padding='SAME'`` gives Conv2dSame."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(0, 1, (k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32) if bias else None
    conv = nn.Conv(cout, (k, k), strides=stride, padding=padding, kernel_dilation=dilation,
                   use_bias=bias, dtype=jnp.bfloat16 if bf16 else None)
    if padding == 'SAME':
        mod = Conv2dSame(cin, cout, k, stride, bias=bias, dilation=dilation)
    else:
        mod = Conv2d(cin, cout, k, stride, padding, dilation, bias=bias)
    mod.compute_dtype = torch.bfloat16 if bf16 else None
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        if bias:
            mod.bias.copy_(torch.from_numpy(b))
    return conv, kernel, b, mod


def _nchw(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).permute(0, 3, 1, 2)


def _activations(kind, dtype, shape=(2, 9, 7, 24), seed=1):
    """NHWC jnp activations: normal, all zero, or on .5 boundaries (max
    |x| = 127, so x * 127 / sa = x exactly, and every value k + 0.5)."""
    rng = np.random.default_rng(seed)
    if kind == 'normal':
        x = rng.normal(0, 2, shape)
    elif kind == 'zeros':
        x = np.zeros(shape)
    else:
        x = rng.integers(-126, 126, shape) + 0.5
        x.flat[0] = 127.0
        x.flat[1] = -2.5
    return jnp.asarray(x.astype(np.float32)).astype(dtype)


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize('kind', ['normal', 'zeros', 'halves'])
def test_quantization_is_octsegs_bit_for_bit(kind, dtype, monkeypatch):
    x = _activations(kind, dtype)
    conv, kernel, b, mod = _pair(24, 256, 3, bf16=dtype == jnp.bfloat16)
    assert quantize.eligible(mod)
    seen = _octseg_operands(monkeypatch)
    jq.quantized_conv(x, jnp.asarray(kernel), jnp.asarray(b), conv)
    (xq_want, wq_want), = seen
    xt = _nchw(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    xq, sa = quantize_activation(xt)
    np.testing.assert_array_equal(xq.numpy(), xq_want)
    assert sa.dtype == torch.float32 and sa.ndim == 0
    assert sa.item() == float(jq._amax(x))
    if kind == 'zeros':
        assert sa.item() == np.float32(1e-8) and not xq.any()
    if kind == 'halves':
        # round half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        assert xq.numpy().reshape(-1)[1] == -2
        np.testing.assert_array_equal(xq.numpy().reshape(-1)[1:] % 2, 0)
    # padded to a multiple of 8 channels with zeros
    xq32, _ = quantize_activation(xt, 32)
    np.testing.assert_array_equal(xq32[..., :24].numpy(), xq_want)
    assert not xq32[..., 24:].any()
    wq, sw = quantize.quantize_weight(mod.weight)
    np.testing.assert_array_equal(wq.permute(1, 2, 3, 0).numpy(), wq_want)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jq._amax(jnp.asarray(kernel),
                                                                  axes=(0, 1, 2))).ravel())


def mod_pads(mod, h, w):
    """The module's ((top, bottom), (left, right)) padding at h x w."""
    if isinstance(mod, Conv2dSame):
        return tuple(same_padding(size, k, s, d) for size, k, s, d in
                     zip((h, w), mod.kernel_size, mod.stride, mod.dilation))
    (ph, pw) = mod.padding
    return (ph, ph), (pw, pw)


GEOMETRIES = [
    # cin, cout, k, stride, dilation, padding, H, W
    (64, 64, 3, 1, 1, 1, 11, 9),
    (40, 112, 3, 2, 1, 1, 13, 10),
    (56, 1000, 1, 2, 1, 0, 12, 9),
    (64, 64, 3, 1, 2, 2, 12, 12),
    (80, 56, 3, 2, 1, 'SAME', 12, 10),
    (56, 40, 5, 2, 1, 'SAME', 13, 14),
    (40, 960, 1, 1, 1, 0, 5, 6),
    (12, 400, 3, 1, 1, 1, 7, 7),
]


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('geometry', GEOMETRIES, ids=lambda g: '-'.join(map(str, g)))
def test_int8_conv_equals_octsegs(geometry, bf16, monkeypatch):
    cin, cout, k, stride, dilation, padding, h, w = geometry
    conv, kernel, b, mod = _pair(cin, cout, k, stride, dilation, padding, bf16=bf16,
                                 seed=cin + cout)
    assert quantize.eligible(mod)
    x = jnp.asarray(np.random.default_rng(k).normal(0, 1, (2, h, w, cin)).astype(np.float32))
    if bf16:
        x = x.astype(jnp.bfloat16)
    seen = _octseg_operands(monkeypatch)
    want = jq.quantized_conv(x, jnp.asarray(kernel), jnp.asarray(b), conv)
    (xq, wq), = seen
    # the int32 sums: XLA's against the plain version's, on octseg's operands
    pads = mod_pads(mod, h, w)
    xla = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride),
        'SAME' if padding == 'SAME' else ((padding, padding), (padding, padding)),
        rhs_dilation=(dilation, dilation), dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32))
    sums = int32_sums_plain(torch.from_numpy(xq), torch.from_numpy(wq).permute(3, 0, 1, 2),
                            (stride, stride), pads, (dilation, dilation))
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.permute(0, 2, 3, 1).numpy(), xla)
    # the whole path, through the module under int8_conv_mode
    xt = _nchw(x).to(torch.bfloat16 if bf16 else torch.float32)
    with torch.no_grad(), quantize.int8_conv_mode():
        got = mod(xt)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert want.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_ineligible_convolutions_stay_exact():
    """Below MIN_MACS, grouped, and transposed convolutions run as without
    int8; the mode is per thread and ends with the block."""
    from octseg_torch.models.common import ConvTranspose2d

    small = Conv2d(8, 8, 3, padding=1)                        # 576 MACs per pixel
    grouped = Conv2d(512, 512, 3, padding=1, groups=512)      # depthwise
    transposed = ConvTranspose2d(256, 256, 3, stride=2)
    assert not any(quantize.eligible(m) for m in (small, grouped, transposed))
    assert quantize.eligible(Conv2d(64, 64, 3)) and not quantize.eligible(Conv2d(64, 63, 3))
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = small(x)
        assert not quantize.int8_active()
        with quantize.int8_conv_mode():
            assert quantize.int8_active()
            torch.testing.assert_close(small(x), want, rtol=0, atol=0)
        assert not quantize.int8_active()


def test_weights_are_quantized_once_and_again_after_a_change():
    _conv, _kernel, _b, mod = _pair(64, 64, 3)
    x = torch.randn(2, 64, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), quantize.int8_conv_mode():
        first = mod(x)
        cached = mod._int8_weights
        mod(x)
        assert mod._int8_weights is cached
        mod.weight.mul_(2)
        second = mod(x)
    assert mod._int8_weights is not cached
    # twice the weights: the same int8 values, twice the scales
    torch.testing.assert_close(second - mod.bias.view(1, -1, 1, 1),
                               2 * (first - mod.bias.view(1, -1, 1, 1)), rtol=1e-6, atol=1e-6)


def _octseg_eligible(arch, encoder, size, classes):
    seen = collections.Counter()

    def interceptor(next_fn, args, kwargs, context):
        mod = context.module
        if (type(mod) is nn.Conv and context.method_name == '__call__'
                and mod.scope is not None and mod.scope.has_variable('params', 'kernel')):
            k = mod.scope.get_variable('params', 'kernel')
            if jq._eligible(mod, k):
                seen[(k.shape[0], k.shape[2], k.shape[3], jq._pair(mod.strides)[0])] += 1
        return next_fn(*args, **kwargs)

    model = jax_create_model(arch, encoder, classes=classes)
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    keys = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)}
    variables = jax.eval_shape(functools.partial(model.init, train=False), keys, x)
    with nn.intercept_methods(interceptor):
        jax.eval_shape(lambda v, x: model.apply(v, x, train=False), variables, x)
    return seen


def _port_eligible(arch, encoder, size, classes, monkeypatch):
    seen = collections.Counter()

    def shape_only(conv, x, pads):
        cout, cin, kh, _kw = conv.weight.shape
        seen[(kh, cin, cout, conv.stride[0])] += 1
        (top, bottom), (left, right) = pads
        return F.conv2d(F.pad(x, (left, right, top, bottom)), conv.weight, conv.bias,
                        conv.stride, 0, conv.dilation)

    monkeypatch.setattr(quantize, 'quantized_conv', shape_only)
    with torch.device('meta'):
        model = create_model(arch, encoder, classes=classes).eval()
        with torch.no_grad():
            quantize.apply_int8(model, torch.empty(1, 3, size, size))
    return seen


@pytest.mark.parametrize('arch,encoder,size,classes,count', WINNERS,
                         ids=[f'{a}-{e}' for a, e, *_ in WINNERS])
def test_eligible_convolutions_are_octsegs(arch, encoder, size, classes, count, monkeypatch):
    want = _octseg_eligible(arch, encoder, size, classes)
    got = _port_eligible(arch, encoder, size, classes, monkeypatch)
    assert sum(want.values()) == count
    assert got == want
