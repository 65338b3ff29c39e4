"""octseg_torch device ops against the JAX package's ops, on the CPU.

resize_nearest and bitpacking are bit-exact; resize_bilinear agrees within
1e-4 on a 0..255 scale at the sizes of tests/test_ops.py and of the main
path, and within float32 coordinate precision at other size pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.ops import bitpack as jax_bitpack
from octseg.ops import normalize as jax_normalize
from octseg.ops import resize as jax_resize
from octseg_torch.ops import bitpack, normalize, resize


@pytest.fixture
def img_f32():  # as tests/test_ops.py's img_u8
    return np.random.default_rng(7).integers(0, 256, (96, 80, 3)).astype(np.float32)


@pytest.mark.parametrize('size', [(48, 40), (64, 64), (192, 160), (512, 512), (35, 77)])
def test_resize_nearest_matches_jax(img_f32, size):
    want = np.asarray(jax_resize.resize_nearest(jnp.asarray(img_f32), size))
    got = resize.resize_nearest(torch.from_numpy(img_f32), size).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('in_size', [63, 70, 96, 186, 500, 896])
def test_resize_nearest_index_parity_adversarial(in_size):
    """The sweep of tests/test_ops.py: cv2's double-rounded reciprocal scale
    differs from floor(x * in / out) for many pairs (63 -> 35 at x = 15)."""
    src = np.arange(in_size, dtype=np.float32)[:, None].repeat(2, 1)[..., None]
    for out in (35, 57, 77, 98, 100, 140, 162, 225, 245, 435, 456, 1000, 1200):
        want = np.asarray(jax_resize.resize_nearest(jnp.asarray(src), (out, 2)))
        got = resize.resize_nearest(torch.from_numpy(src), (out, 2)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f'{in_size}->{out}')


def test_resize_nearest_is_not_torch_nearest():
    """63 -> 35 is one of the pairs where F.interpolate's nearest is off by
    one from cv2; the port must follow cv2 (and the JAX package)."""
    src = torch.arange(63, dtype=torch.float32).reshape(1, 1, 63, 1)
    torch_nearest = torch.nn.functional.interpolate(src, size=(35, 1), mode='nearest')
    ours = resize.resize_nearest_nchw(src, (35, 1))
    assert not torch.equal(ours, torch_nearest)
    assert float(ours[0, 0, 15, 0]) == 26.0


@pytest.mark.parametrize('in_hw,size', [
    ((96, 80), (48, 40)), ((96, 80), (192, 160)),      # tests/test_ops.py's sizes
    ((704, 704), (512, 512)), ((512, 512), (1000, 1000)),  # the main path's
    ((100, 90), (64, 64)), ((96, 80), (96, 80)),
])
def test_resize_bilinear_matches_jax(in_hw, size):
    x = np.random.default_rng(7).integers(0, 256, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), size))
    got = resize.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _bilinear_float64(x, size):
    """cv2.INTER_LINEAR computed exactly in float64 (NHWC)."""
    for axis, out in ((1, size[0]), (2, size[1])):
        n = x.shape[axis]
        src = np.maximum((np.arange(out) + 0.5) * (n / out) - 0.5, 0)
        i0 = np.minimum(np.floor(src).astype(int), n - 1)
        lam = (src - i0).reshape([-1 if a == axis else 1 for a in range(x.ndim)])
        x = np.take(x, i0, axis) * (1 - lam) + np.take(x, np.minimum(i0 + 1, n - 1), axis) * lam
    return x


@pytest.mark.parametrize('in_hw,size', [
    ((96, 80), (50, 61)), ((64, 64), (80, 72)), ((37, 53), (101, 29)),
    ((96, 80), (70, 333)), ((63, 70), (35, 57)),
])
def test_resize_bilinear_within_float32_coordinate_precision(in_hw, size):
    """For size pairs whose scale is not a power of two, both frameworks round
    the float32 source coordinate (dst + 0.5) * in/out - 0.5, and differently
    (XLA fuses the multiply-add): a 0..255 result moves by up to
    255 * 2 ulp(max(in, out)). Both stay that close to the exact value, and
    so to each other."""
    x = np.random.default_rng(8).integers(0, 256, (2, *in_hw, 3)).astype(np.float32)
    bound = 255 * 2 * np.spacing(np.float32(max(*in_hw, *size)))
    exact = _bilinear_float64(x.astype(np.float64), size)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), size))
    got = resize.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert np.abs(want - exact).max() <= bound
    assert np.abs(got - exact).max() <= bound
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize('w', [8, 13, 1000, 1003])
def test_pack_mask_bits_matches_jax(w):
    masks = np.random.default_rng(w).integers(0, 2, (3, 5, w, 2)).astype(np.uint8)
    want = np.asarray(jax_bitpack.pack_mask_bits(jnp.asarray(masks)))
    got = bitpack.pack_mask_bits(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bitpack.pack_mask_bits(torch.from_numpy(masks).bool()).numpy(), want)
    np.testing.assert_array_equal(bitpack.unpack_mask_bits(got, w), masks)


def test_unpack_route_into_matches_jax():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (2, 4, 3, 2)).astype(np.uint8)
    routes = [(0, 2), (1, 1)]
    want = np.zeros((2, 4, 21, 4), np.float32)
    jax_bitpack._unpack_route_numpy(packed, want, routes)
    got = np.zeros_like(want)
    bitpack.unpack_route_into(packed, got, routes)
    np.testing.assert_array_equal(got, want)


def test_normalize_and_threshold_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (2, 6, 5, 3)).astype(np.float32)
    want = np.asarray(jax_normalize.normalize_imagenet(jnp.asarray(x), input_scale=1 / 255))
    got = normalize.normalize_imagenet(torch.from_numpy(x), input_scale=1 / 255).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    logits = rng.normal(size=(4, 7)).astype(np.float32)
    logits[0, :3] = 0.0
    for thr in (0.5, 0.3):
        np.testing.assert_array_equal(
            normalize.sigmoid_threshold(torch.from_numpy(logits), thr).numpy(),
            np.asarray(jax_normalize.sigmoid_threshold(jnp.asarray(logits), thr)))
