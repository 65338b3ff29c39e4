"""The fused overlay postprocess of octseg_torch against the JAX package.

On the CPU the port's wrapper runs the kernel's plain torch version
(postprocess_chain); it is held against the JAX package's Pallas kernel in
interpret mode and its XLA chain: ring bit-exact, fill within 1e-5 (as
tests/test_pallas_kernels.py holds the Pallas kernel). The CUDA kernel
itself runs only on a card (marker ``cuda``; chip_smoke.py checks it too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.data.utils import _postprocess_chain as jax_chain
from octseg.ops.pallas.postprocess import fused_overlay_postprocess as jax_fused
from octseg_torch.data import utils as torch_utils
from octseg_torch.ops import morphology
from octseg_torch.ops.kernels import postprocess


def _disc_masks(rng, m, h, w):
    """1-3 random filled discs per mask (tests/test_pallas_kernels.py's
    _random_masks without cv2)."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((m, h, w), np.float32)
    for i in range(m):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(3, max(h, w) // 4))
            out[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1.0
    return out


def _border_masks():
    masks = np.zeros((1, 64, 200), np.float32)
    masks[0, :10, :10] = 1
    masks[0, -8:, -12:] = 1
    masks[0, 30:40, 0:5] = 1
    masks[0, 0:5, 100:140] = 1
    return masks


def _check(masks, fill_ref, ring_ref):
    fill, ring = postprocess.fused_overlay_postprocess(torch.from_numpy(masks))
    np.testing.assert_array_equal(ring.numpy(), np.asarray(ring_ref))
    np.testing.assert_allclose(fill.numpy(), np.asarray(fill_ref), rtol=0, atol=1e-5)


def test_plain_chain_matches_pallas_interpret():
    masks = _disc_masks(np.random.default_rng(1), 2, 96, 128)
    _check(masks, *jax_fused(jnp.asarray(masks), interpret=True))


def test_plain_chain_matches_pallas_interpret_border_touching():
    masks = _border_masks()
    _check(masks, *jax_fused(jnp.asarray(masks), interpret=True))


@pytest.mark.parametrize('shape', [(1, 300, 140), (3, 130, 250), (2, 17, 9)])
def test_plain_chain_matches_jax_chain(shape):
    masks = _disc_masks(np.random.default_rng(2), *shape)
    _check(masks, *jax_chain(jnp.asarray(masks)))


def test_morphology_matches_jax():
    from octseg.ops import morphology as jm

    masks = _disc_masks(np.random.default_rng(3), 2, 40, 50)
    x, xt = jnp.asarray(masks), torch.from_numpy(masks)
    for se in (morphology.ELLIPSE_5, morphology.ELLIPSE_7):
        np.testing.assert_array_equal(morphology.dilate(xt, se).numpy(),
                                      np.asarray(jm.dilate(x, se)))
        np.testing.assert_array_equal(morphology.erode(xt, se).numpy(),
                                      np.asarray(jm.erode(x, se)))
    np.testing.assert_array_equal(morphology.ELLIPSE_5, jm.ELLIPSE_5)
    np.testing.assert_array_equal(morphology.ELLIPSE_7, jm.ELLIPSE_7)
    np.testing.assert_array_equal(morphology.GAUSS_5, jm.GAUSS_5)
    np.testing.assert_allclose(morphology.gaussian_blur5(xt).numpy(),
                               np.asarray(jm.gaussian_blur5(x)), rtol=0, atol=1e-6)


def test_postprocess_masks_on_cpu_is_the_plain_chain():
    masks = torch.from_numpy(_disc_masks(np.random.default_rng(4), 2, 33, 47))
    before = postprocess.launches
    fill, ring = torch_utils.postprocess_masks(masks)
    pfill, pring = torch_utils._postprocess_chain(masks)
    assert torch.equal(fill, pfill) and torch.equal(ring, pring)
    assert postprocess.launches == before  # no kernel on the CPU


@pytest.mark.parametrize('bad,error', [
    (torch.zeros(4, 8), ValueError),                     # rank
    (torch.zeros(1, 2, 8), ValueError),                  # too small for the blur
    (torch.zeros(1, 8, 8, dtype=torch.float64), TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        postprocess.fused_overlay_postprocess(bad)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_chain():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    rng = np.random.default_rng(5)
    for masks in (_disc_masks(rng, 3, 130, 250), _border_masks(), _disc_masks(rng, 2, 1000, 1000)):
        m = torch.from_numpy(masks).cuda()
        before = postprocess.launches
        fill, ring = postprocess.fused_overlay_postprocess(m)
        torch.cuda.synchronize()
        assert postprocess.launches == before + 1
        pfill, pring = postprocess.postprocess_chain(m)
        assert torch.equal(ring, pring)
        assert float((fill - pfill).abs().max()) <= 1e-5
    with pytest.raises(ValueError):
        postprocess.fused_overlay_postprocess(torch.zeros(2, 8, 16, device='cuda')[:, :, ::2])
