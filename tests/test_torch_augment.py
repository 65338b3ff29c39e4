"""octseg_torch's augmentation against the JAX package's.

jax.random and torch draw different numbers from one seed, so the tests
draw octseg's numbers from its own key schedule (``_geom_params`` and
``_photometric``), hand them to the port's ``geometry``, ``photometric`` and
``apply_augment``, and compare; the port's own draws are held to the
policy's probabilities and ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.ops import augment as jax_augment
from octseg_torch.ops import augment
from octseg_torch.ops.warp import apply_homography, matmul3, pixel_grid


def jax_draws(key, h, w, channels=3):
    """octseg's draws for one sample, in the port's ``params`` layout, from
    the key schedule of ``_geom_params`` and ``_photometric``."""
    keys = jax.random.split(key, 16)

    def u(k, lo=0.0, hi=1.0, shape=()):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    pkeys = jax.random.split(keys[15], 3)
    bkeys = jax.random.split(pkeys[2], 6)
    sv1, sv2 = jax.random.split(bkeys[5])
    ch = jnp.floor(u(keys[7], 0.8, 0.9) * h)
    cw = jnp.floor(u(keys[8], 0.8, 0.9) * w)
    p = {
        'flip': u(keys[0]) < 0.5, 'ssr': u(keys[1]) < 0.20,
        'shift_x': u(keys[2], -0.0625, 0.0625) * w, 'shift_y': u(keys[3], -0.0625, 0.0625) * h,
        'scale': 1.0 + u(keys[4], -0.1, 0.1), 'angle': u(keys[5], -15.0, 15.0) * jnp.pi / 180.0,
        'crop': u(keys[6]) < 0.20, 'ch': ch, 'cw': cw,
        'y0': jnp.floor(u(keys[9]) * (h - ch)), 'x0': jnp.floor(u(keys[10]) * (w - cw)),
        'persp': u(keys[14]) < 0.20,
        'jitter': jax.random.normal(pkeys[1], (4, 2)) * u(pkeys[0], 0.05, 0.1),
        'noise_on': u(keys[11]) < 0.15,
        'noise': jax.random.normal(keys[13], (h, w, channels)) * jnp.sqrt(u(keys[12], 1.5, 6.5)),
        'bc': u(bkeys[0]) < 0.15, 'alpha': 1.0 + u(bkeys[1], -0.15, 0.15),
        'beta': u(bkeys[2], -0.15, 0.15) * 255.0,
        'hsv': u(bkeys[3]) < 0.15, 'h_shift': u(bkeys[4], -15.0, 15.0),
        's_shift': u(sv1, -20.0, 20.0), 'v_shift': u(sv2, -15.0, 15.0),
    }
    return p


def batch_draws(keys, h, w):
    """The port's params (torch, batched) for octseg's per-sample keys."""
    per = [jax_draws(k, h, w) for k in keys]
    return {name: torch.from_numpy(np.stack([np.asarray(p[name]) for p in per]))
            for name in per[0]}


def _keys(n, seed):
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_geometry_matches_jax_geom_params():
    h = w = 64
    keys = _keys(48, 0)
    params = batch_draws(keys, h, w)
    for name in ('flip', 'ssr', 'crop', 'persp'):
        assert params[name].any() and not params[name].all(), name
    m_pre, m_persp, rect = augment.geometry(params, h, w)
    for i, key in enumerate(keys):
        want_pre, want_persp, want_rect, _ = jax_augment._geom_params(key, h, w)
        assert _rel(m_pre[i].numpy(), np.asarray(want_pre)) <= 1e-5
        assert _rel(m_persp[i].numpy(), np.asarray(want_persp)) <= 1e-5
        np.testing.assert_array_equal(rect[i].numpy(), np.asarray(want_rect))


def test_photometric_matches_jax_given_the_same_draws():
    h, w = 16, 20
    keys = _keys(64, 1)
    params = batch_draws(keys, h, w)
    for name in ('noise_on', 'bc', 'hsv'):
        assert params[name].any(), name
    imgs = np.random.default_rng(1).uniform(0, 255, (len(keys), h, w, 3)).astype(np.float32)
    got = augment.photometric(torch.from_numpy(imgs), params).numpy()
    for i, key in enumerate(keys):
        phot_keys = jax_augment._geom_params(key, h, w)[3]
        want = np.asarray(jax_augment._photometric(jnp.asarray(imgs[i]), phot_keys))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-3)


def test_apply_augment_matches_augment_pair():
    """octseg's portable path warps by m_persp, then m_pre; the port by the
    composed m_pre @ m_persp (as octseg's TPU path). Coordinates then differ
    by rounding only, so a mask pixel may differ only where a coordinate lies
    within 1e-4 of a rounding boundary (a multiple of 0.5)."""
    h = w = 48
    keys = _keys(24, 2)
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, (len(keys), h, w, 3)).astype(np.float32)
    masks = (rng.random((len(keys), h, w, 4)) > 0.5).astype(np.float32)
    want_i, want_m = jax.vmap(jax_augment.augment_pair)(jnp.asarray(imgs), jnp.asarray(masks),
                                                        jnp.stack(keys))
    params = batch_draws(keys, h, w)
    got_i, got_m = augment.apply_augment(torch.from_numpy(imgs), torch.from_numpy(masks), params)
    m_pre, m_persp, _ = augment.geometry(params, h, w)
    xs, ys = pixel_grid(h, w, 'cpu')
    sx, sy = apply_homography(matmul3(m_pre, m_persp), xs, ys)
    near = np.zeros(sx.shape, bool)
    for c in (sx.numpy(), sy.numpy()):
        near |= np.abs(2 * c - np.round(2 * c)) < 2e-4
    near = near[..., None]
    differ = got_m.numpy() != np.asarray(want_m)
    assert not (differ & ~near).any()
    assert differ.mean() < 1e-3
    far = np.broadcast_to(~near, got_i.shape)
    np.testing.assert_allclose(got_i.numpy()[far], np.asarray(want_i)[far], rtol=0, atol=1e-2)


def test_draws_follow_the_policy():
    n, h, w = 4096, 32, 40
    p = augment.draw_params(n, h, w, torch.Generator().manual_seed(0))
    for name, prob in augment.BRANCH_P.items():
        rate = float(p[name].float().mean())
        assert abs(rate - prob) <= 4 * (prob * (1 - prob) / n) ** 0.5, (name, rate)
    ranges = {'shift_x': (-0.0625 * w, 0.0625 * w), 'shift_y': (-0.0625 * h, 0.0625 * h),
              'scale': (0.9, 1.1), 'angle': (-np.pi / 12, np.pi / 12),
              'ch': (np.floor(0.8 * h), np.floor(0.9 * h)),
              'cw': (np.floor(0.8 * w), np.floor(0.9 * w)),
              'alpha': (0.85, 1.15), 'beta': (-0.15 * 255, 0.15 * 255),
              'h_shift': (-15, 15), 's_shift': (-20, 20), 'v_shift': (-15, 15)}
    for name, (lo, hi) in ranges.items():
        v = p[name].numpy()
        assert v.min() >= lo - 1e-5 and v.max() <= hi + 1e-5, name
    assert (p['y0'] >= 0).all() and (p['y0'] <= h - p['ch']).all()
    assert (p['x0'] >= 0).all() and (p['x0'] <= w - p['cw']).all()
    assert p['jitter'].shape == (n, 4, 2) and p['noise'].shape == (n, h, w, 3)
    sd = float(p['noise'].std())
    assert 1.5 ** 0.5 < sd < 6.5 ** 0.5


def test_same_seed_same_batch():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.uniform(0, 255, (4, 40, 40, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.random((4, 40, 40, 2)) > 0.5).astype(np.float32))
    a = augment.augment_batch(imgs, masks, torch.Generator().manual_seed(7))
    b = augment.augment_batch(imgs, masks, torch.Generator().manual_seed(7))
    c = augment.augment_batch(imgs, masks, torch.Generator().manual_seed(8))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert set(torch.unique(a[1]).tolist()) <= {0.0, 1.0}
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 255


def test_generator_must_live_on_the_batch_device():
    imgs = torch.zeros(1, 8, 8, 3, device='meta')
    masks = torch.zeros(1, 8, 8, 1, device='meta')
    with pytest.raises(ValueError):
        augment.augment_batch(imgs, masks, torch.Generator())
