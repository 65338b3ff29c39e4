"""The fused overlay postprocess of octseg_torch against the JAX package.

On the CPU the port's wrapper runs the kernel's plain torch version
(postprocess_chain); it is held against the JAX package's Pallas kernel in
interpret mode and its XLA chain: ring bit-exact, fill within 1e-5 (as
tests/test_pallas_kernels.py holds the Pallas kernel). The CUDA kernel
itself runs only on a card (marker ``cuda``; chip_smoke.py checks it too).

``_emulate_k1`` repeats the CUDA kernel's packed-word algorithm in numpy
(ballot packing into 32-pixel words, shift-and-OR ellipse dilations with
carry bits, the masking of the last word, the tiles with their halos, the
REFLECT_101 patch and the integer blur through the kernel's tables), so
that a word-boundary fault shows on the CPU before a run on the card.
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
from tests.torch_threads import torch_threads_share  # noqa: F401


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


FULL = np.uint64(0xFFFFFFFF)
HALO = 7
# the CUDA kernel's tile: K1_ROWS output rows by CW words (csrc/postprocess.cu)
KERNEL_ROWS, KERNEL_CW = 32, 32


def _fsl(lo, hi, s):
    """__funnelshift_l: the high word of (hi:lo) << s."""
    return ((hi << np.uint64(s)) | (lo >> np.uint64(32 - s))) & FULL


def _fsr(lo, hi, s):
    """__funnelshift_r: the low word of (hi:lo) >> s."""
    return ((lo >> np.uint64(s)) | (hi << np.uint64(32 - s))) & FULL


def _hdil(a, r):
    """Each row word of ``a`` (rows, words) dilated by r pixels, with the
    neighbours' carry bits (0 past the array's ends)."""
    zero = np.zeros_like(a[:, :1])
    prev = np.concatenate([zero, a[:, :-1]], 1)
    nxt = np.concatenate([a[:, 1:], zero], 1)
    v = a.copy()
    for s in range(1, r + 1):
        v |= _fsl(prev, a, s) | _fsr(a, nxt, s)
    return v


def _dil5(a, r0, r1):
    """ELLIPSE_5 dilation of rows r0..r1-1: rows +-1 at +-2 px, rows +-2 at
    the centre."""
    h2 = _hdil(a, 2)
    return a[r0 - 2:r1 - 2] | a[r0 + 2:r1 + 2] | h2[r0 - 1:r1 - 1] | h2[r0:r1] | h2[r0 + 1:r1 + 1]


def _dil7(a, r0, r1):
    """ELLIPSE_7: rows +-1 at +-3 px, rows +-2 at +-2, rows +-3 at the centre."""
    h2, h3 = _hdil(a, 2), _hdil(a, 3)
    return (a[r0 - 3:r1 - 3] | a[r0 + 3:r1 + 3] | h2[r0 - 2:r1 - 2] | h2[r0 + 2:r1 + 2]
            | h3[r0 - 1:r1 - 1] | h3[r0:r1] | h3[r0 + 1:r1 + 1])


def _tables():
    """The kernel's tables: 8 bits x-2..x+5 -> the row sums [1 4 6 4 1] of
    pixels x..x+3, and 4 ring bits -> 4 floats."""
    b = np.arange(256)
    h = [sum(wt * ((b >> (p + i)) & 1) for i, wt in enumerate((1, 4, 6, 4, 1)))
         for p in range(4)]
    rl = (np.arange(16)[:, None] >> np.arange(4)) & 1
    return np.stack(h, -1), rl.astype(np.float32)


def _reflect101(i, n):
    i = abs(i)
    return 2 * (n - 1) - i if i > n - 1 else i


def _emulate_k1(masks, rows=KERNEL_ROWS, cw=KERNEL_CW, seed=0, fault=None):
    """(fill, ring) of (M, H, W) {0,1} masks by the CUDA kernel's algorithm,
    tile by tile. Shared words that a stage does not write start as random
    bits, so reading one that the kernel leaves unset shows. ``fault``
    ('no_reflect_patch', 'last_word_unmasked') breaks one step, for the
    controls."""
    m_count, h, w = masks.shape
    nw = -(-w // 32)
    last = np.uint64((1 << (w % 32)) - 1 if w % 32 and fault != 'last_word_unmasked'
                     else 0xFFFFFFFF)
    sr, sw = rows + 2 * HALO, cw + 2
    # ballot packing: bit i of word j is pixel 32 j + i where v > 0.5
    bits = np.zeros((m_count, h, nw * 32), np.uint64)
    bits[..., :w] = masks > 0.5
    words = (bits.reshape(m_count, h, nw, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    hlut, rlut = _tables()
    garbage = np.random.default_rng(seed)
    fill = np.zeros(masks.shape, np.float32)
    ring = np.zeros(masks.shape, np.float32)
    for mi in range(m_count):
        for y0 in range(0, h, rows):
            for j0 in range(0, nw, cw):
                gy = y0 - HALO + np.arange(sr)
                gj = j0 - 1 + np.arange(sw)
                rin, cin = (gy >= 0) & (gy < h), (gj >= 0) & (gj < nw)
                inside = np.where(rin[:, None] & cin[None, :],
                                  np.where(gj == nw - 1, last, FULL)[None, :], 0).astype(np.uint64)

                def junk():
                    return garbage.integers(0, 1 << 32, (sr, sw), dtype=np.uint64)

                s_a, s_b, s_c = np.zeros((sr, sw), np.uint64), junk(), junk()
                s_a[np.ix_(rin, cin)] = words[mi][np.ix_(gy[rin], gj[cin])]
                s_b[2:sr - 2] = ~_dil5(s_a, 2, sr - 2) & FULL & inside[2:sr - 2]
                c = ~_dil5(s_b, 4, sr - 4) & FULL & inside[4:sr - 4]
                s_c[4:sr - 4] = c
                s_a[4:sr - 4] = ~c & FULL & inside[4:sr - 4]
                s_b[HALO:HALO + rows, 1:cw + 1] = (_dil7(s_c, HALO, HALO + rows)
                                                   & _dil7(s_a, HALO, HALO + rows))[:, 1:cw + 1]

                def bit(r, x):
                    return (int(s_c[r, (x >> 5) - j0 + 1]) >> (x & 31)) & 1

                def set_bit(r, x, b):
                    k, sh = (x >> 5) - j0 + 1, x & 31
                    s_c[r, k] = np.uint64((int(s_c[r, k]) & ~(1 << sh)) | (b << sh))

                for r in range(HALO - 2, HALO + rows + 2):
                    if not 0 <= y0 - HALO + r < h or fault == 'no_reflect_patch':
                        continue
                    if j0 == 0:
                        set_bit(r, -1, bit(r, 1))
                        set_bit(r, -2, bit(r, 2))
                    if (w + 1) >> 5 <= j0 + cw:
                        set_bit(r, w, bit(r, w - 2))
                        set_bit(r, w + 1, bit(r, w - 3))
                out_words = min(cw, nw - j0)
                k = 1 + np.arange(out_words)[:, None]          # (words, 1)
                b = np.arange(0, 32, 4)[None, :]                 # (1, 8)
                x = (j0 + k - 1) * 32 + b                        # first of 4 pixels
                for r in range(HALO, HALO + min(rows, h - y0)):
                    y = y0 - HALO + r
                    acc = np.zeros((out_words, 8, 4), np.int64)
                    for dy, wt in zip(range(-2, 3), (1, 4, 6, 4, 1)):
                        rr = _reflect101(y + dy, h) - y0 + HALO
                        lo = np.where(b == 0, s_c[rr, k - 1], s_c[rr, k])
                        hi = np.where(b == 0, s_c[rr, k], s_c[rr, k + 1])
                        win = _fsr(lo, hi, (b - 2) & 31) & np.uint64(255)
                        acc += wt * hlut[win.astype(np.int64)]
                    rg = rlut[((s_b[r, k] >> b.astype(np.uint64)) & np.uint64(15)).astype(np.int64)]
                    px = x[..., None] + np.arange(4)
                    keep = px < w
                    fill[mi, y, px[keep]] = (acc * np.float32(1 / 256)).astype(np.float32)[keep]
                    ring[mi, y, px[keep]] = rg[keep]
    return fill, ring


def _edge_masks(kind, shape, seed):
    """All ones, all zeros, a frame touching all four borders, or random
    (one in ten set: denser noise closes into all ones)."""
    if kind == 'ones':
        return np.ones(shape, np.float32)
    if kind == 'zeros':
        return np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    if kind == 'random':
        return (rng.random(shape) > 0.9).astype(np.float32)
    masks = (rng.random(shape) > 0.8).astype(np.float32)
    masks[:, 0, :] = masks[:, -1, :] = 1
    masks[:, :, 0] = masks[:, :, -1] = 1
    masks[:, 1:3, 1:3] = 0
    return masks


EMULATION_SHAPES = [(2, 3, 3), (1, 4, 31), (2, 17, 33), (1, 40, 64), (1, 9, 100)]


@pytest.mark.parametrize('kind', ['ones', 'zeros', 'border', 'random'])
@pytest.mark.parametrize('shape', EMULATION_SHAPES)
def test_word_algorithm_matches_plain_chain(shape, kind):
    """The kernel's algorithm at its own tile (32 rows by 32 words) and at a
    tile of 4 rows by 1 word, whose halos then cross rows and words."""
    masks = _edge_masks(kind, shape, seed=sum(shape))
    pfill, pring = postprocess.postprocess_chain(torch.from_numpy(masks))
    for rows, cw in ((KERNEL_ROWS, KERNEL_CW), (4, 1)):
        fill, ring = _emulate_k1(masks, rows, cw)
        np.testing.assert_array_equal(ring, pring.numpy())
        np.testing.assert_array_equal(fill, pfill.numpy())


@pytest.mark.parametrize('fault', ['no_reflect_patch', 'last_word_unmasked'])
def test_word_algorithm_emulation_can_fail(fault):
    """Controls: without the REFLECT_101 patch of the blur's edge columns, or
    with the bits past W left inside the frame, the emulation disagrees."""
    masks = _edge_masks('random', (1, 9, 37), seed=1)
    pfill, pring = postprocess.postprocess_chain(torch.from_numpy(masks))
    fill, ring = _emulate_k1(masks, 4, 1, fault=fault)
    assert not (np.array_equal(fill, pfill.numpy()) and np.array_equal(ring, pring.numpy()))


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
    # word boundaries (1000 = 31 words + 8 bits), heights 3 and 4, three
    # column tiles (2100 px), more masks than one grid's z, and every kind
    edges = [_edge_masks(kind, (2, h, w), h + w) for kind in ('ones', 'zeros', 'border', 'random')
             for h in (3, 4) for w in (3, 31, 32, 33, 1000)]
    for masks in (_disc_masks(rng, 3, 130, 250), _border_masks(), _disc_masks(rng, 2, 1000, 1000),
                  *edges, _edge_masks('random', (1, 40, 2100), 8),
                  _edge_masks('random', (65537, 3, 5), 9)):
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
