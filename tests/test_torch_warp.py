"""The augmentation warp (TPU kernel K2's port) against the JAX package.

``sample_pair_plain`` is the plain torch version of K2; its semantics are
octseg's ``_sample_pair_fused``, which the Pallas kernel
(``warp_pair_2pass``) names as its parity target. On the CPU the port must
equal the gather sampler given the same coordinates, and track the Pallas
kernel (run in interpret mode) at the tolerances tests/test_ops.py holds it
to. The CUDA kernel runs only on a card (marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.ops import warp as jax_warp
from octseg.ops.pallas.resample import warp_pair_2pass
from octseg_torch.ops import warp
from octseg_torch.ops.kernels import warp as k2
from tests.torch_threads import torch_threads_share  # noqa: F401


def _batch(rng, n, h, w, ci=3, cm=4):
    imgs = rng.uniform(0, 255, (n, h, w, ci)).astype(np.float32)
    masks = (rng.random((n, h, w, cm)) > 0.6).astype(np.float32)
    return imgs, masks


def _mats(h, w):
    """Flip, shift, scale, rotation, perspective and a map that leaves the
    frame in part: every border case of the sampler."""
    c = ((w - 1) / 2, (h - 1) / 2)
    persp = np.asarray(jax_warp.perspective_from_corners(
        jnp.asarray([[3.0, 2.0], [w - 5.0, 1.0], [w - 2.0, h - 4.0], [1.0, h - 1.0]]),
        jnp.asarray([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]])))
    return np.stack([
        np.eye(3),
        [[-1, 0, w - 1], [0, 1, 0], [0, 0, 1]],
        [[1, 0, 3.7], [0, 1, -2.3], [0, 0, 1]],
        np.asarray(jax_warp.affine_matrix(0.0, 0.0, 1.1, 0.0, *c)),
        np.asarray(jax_warp.affine_matrix(2.0, -1.0, 0.95, np.deg2rad(15), *c)),
        persp,
        [[1.3, 0.2, -9.0], [-0.1, 0.9, 14.5], [0, 0, 1]],
    ]).astype(np.float32)


def _coords(mats, h, w):
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    m = mats[:, :, :, None, None]
    pw = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
    return ((m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]) / pw,
            (m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]) / pw)


@pytest.mark.parametrize('hw', [(32, 32), (40, 52)])
def test_sample_pair_at_matches_jax_gather_sampler(hw):
    h, w = hw
    mats = _mats(h, w)
    imgs, masks = _batch(np.random.default_rng(h), len(mats), h, w)
    sx, sy = _coords(mats, h, w)
    want_i, want_m = jax.vmap(jax_warp._sample_pair_fused)(
        jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(sx), jnp.asarray(sy))
    got_i, got_m = warp.sample_pair_at(torch.from_numpy(imgs), torch.from_numpy(masks),
                                       torch.from_numpy(sx), torch.from_numpy(sy))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0, atol=1e-3)


def test_warp_pair_on_the_cpu_is_the_plain_version():
    h, w = 24, 30
    mats = torch.from_numpy(_mats(h, w))
    imgs, masks = (torch.from_numpy(a) for a in _batch(np.random.default_rng(1), len(mats), h, w))
    before = k2.launches
    got = k2.warp_pair(imgs, masks, mats)
    want = warp.sample_pair_plain(imgs, masks, mats)
    assert k2.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == imgs.shape and got[1].shape == masks.shape


def test_warp_pair_rejects_bad_inputs():
    imgs, masks = torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 4)
    mats = torch.eye(3).expand(2, 3, 3)
    with pytest.raises(ValueError):
        k2.warp_pair(imgs[0], masks, mats)
    with pytest.raises(ValueError):
        k2.warp_pair(imgs, masks[:, :4], mats)
    with pytest.raises(ValueError):
        k2.warp_pair(imgs, masks, mats[:1])
    with pytest.raises(TypeError):
        k2.warp_pair(imgs.double(), masks, mats)


def _pallas(imgs, masks, mats):
    oi, om = warp_pair_2pass(jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(mats),
                             interpret=True)
    return np.asarray(oi), np.asarray(om)


def test_axis_aligned_maps_match_the_pallas_kernel():
    """No rotation or perspective: the two-pass kernel is the same stencil
    (tests/test_ops.py: images to bf16 tolerance, masks equal)."""
    size = 32
    mats = _mats(size, size)[:4]   # identity, flip, shift, scale
    imgs, masks = _batch(np.random.default_rng(2), len(mats), size, size)
    want_i, want_m = _pallas(imgs, masks, mats)
    got_i, got_m = warp.sample_pair_plain(torch.from_numpy(imgs), torch.from_numpy(masks),
                                          torch.from_numpy(mats))
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=0, atol=2.0)
    np.testing.assert_array_equal(got_m.numpy(), want_m)


def test_rotation_masks_agree_with_the_pallas_kernel():
    size = 32
    mats = _mats(size, size)[4:5]
    imgs, masks = _batch(np.random.default_rng(3), 1, size, size)
    _want_i, want_m = _pallas(imgs, masks, mats)
    _got_i, got_m = warp.sample_pair_plain(torch.from_numpy(imgs), torch.from_numpy(masks),
                                           torch.from_numpy(mats))
    assert (got_m.numpy() == want_m).mean() > 0.95


def test_rotation_of_a_smooth_image_tracks_the_pallas_kernel():
    size = 64
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    imgs = np.stack([xx * 2, yy * 2, xx + yy], -1)[None]
    masks = (((xx - 32) ** 2 + (yy - 32) ** 2) < 200).astype(np.float32)[None, ..., None]
    m = np.array(jax_warp.affine_matrix(1.5, -0.5, 1.05, np.deg2rad(12), (size - 1) / 2,
                                        (size - 1) / 2), np.float32)[None]
    want_i, _ = _pallas(imgs, masks, m)
    got_i, got_m = warp.sample_pair_plain(torch.from_numpy(imgs), torch.from_numpy(masks),
                                          torch.from_numpy(m))
    d = np.abs(got_i.numpy() - want_i)
    assert d.mean() < 1.0 and d.max() < 8.0
    assert abs(float(got_m.sum()) - 621 * 1.05 ** 2) / 621 < 0.05


def test_affine_and_perspective_matrices_match_jax():
    rng = np.random.default_rng(4)
    shift = rng.uniform(-30, 30, (2, 6)).astype(np.float32)
    scale = rng.uniform(0.9, 1.1, 6).astype(np.float32)
    angle = rng.uniform(-0.3, 0.3, 6).astype(np.float32)
    got = warp.affine_matrix(torch.from_numpy(shift[0]), torch.from_numpy(shift[1]),
                             torch.from_numpy(scale), torch.from_numpy(angle), 255.5, 255.5)
    for i in range(6):
        want = np.asarray(jax_warp.affine_matrix(shift[0, i], shift[1, i], scale[i], angle[i],
                                                 255.5, 255.5))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-6)
    corners = np.array([[0, 0], [511, 0], [511, 511], [0, 511]], np.float32)
    sign = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    src = corners + np.abs(rng.normal(0, 0.08, (6, 4, 2))).astype(np.float32) * sign * 512
    got = warp.perspective_from_corners(torch.from_numpy(src.astype(np.float32)),
                                        torch.from_numpy(corners))
    for i in range(6):
        want = np.asarray(jax_warp.perspective_from_corners(jnp.asarray(src[i]),
                                                            jnp.asarray(corners)))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-8)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    # the 3 + 4 channel path (W % 4 == 0), and the general one: other channel
    # counts and widths that are not a multiple of 4
    for h, w, ci, cm in ((32, 32, 3, 4), (130, 250, 3, 4), (512, 512, 3, 4), (96, 128, 1, 1),
                         (96, 128, 3, 1), (64, 61, 3, 4)):
        mats = torch.from_numpy(_mats(h, w)).cuda()
        imgs, masks = (torch.from_numpy(a).cuda()
                       for a in _batch(np.random.default_rng(h), len(mats), h, w, ci, cm))
        before = k2.launches
        got_i, got_m = k2.warp_pair(imgs, masks, mats)
        torch.cuda.synchronize()
        assert k2.launches == before + 1
        want_i, want_m = warp.sample_pair_plain(imgs, masks, mats)
        assert torch.equal(got_m, want_m)
        assert float((got_i - want_i).abs().max()) <= 1e-4
