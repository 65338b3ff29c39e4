"""The image-directory predict path of octseg_torch against the JAX package's.

Both entry points run one directory of RGB, RGBA, gray (L) and palette (P)
PNGs and baseline JPEGs (4:2:0 colour and gray) of several sizes through
the same three model dirs (Unet/resnet18 at 64 px, octseg-trained manifests,
heads softened as in tests/test_torch_engine_families.py so that few pixels
sit at p = 0.5), four classes, output 80x80. The PNGs are decoded with PIL
and compared: a mask pixel may differ only where the JAX probability lies
within 1e-4 of 0.5, and the overlay only within the postprocess's reach of
such a pixel (close 2 + ring 3 + blur 2 pixels); where the masks are
equal, the overlays are pixel for pixel the same.

The host steps are also held alone against Pillow and cv2: the Pillow
resize of each mode the port reads (bicubic for L and RGB, bicubic on
premultiplied alpha for RGBA, NEAREST for P), ``preprocessing_img`` against
``np.array`` + ``cv2.cvtColor(RGB2BGR)`` + ``cv2.resize``, and
``data_processing``'s names, order and masks. Which other modes octseg
accepts is written down by a test: the port raises for each of them.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from octseg.core.config import Config as JaxConfig
from octseg.data import utils as jax_utils
from octseg.infer import predict as jax_predict
from octseg.infer.engine import MODELS_META
from octseg.ops.normalize import normalize_imagenet as jax_normalize
from octseg.ops.resize import resize_bilinear as jax_resize_bilinear
from octseg_torch.core.config import Config
from octseg_torch.data import utils
from octseg_torch.data.image import PilImage, open_image, pil_resize
from octseg_torch.infer import predict
from octseg_torch.train.checkpoint import initialize_model_dir, load_weights, save_weights
from tests.test_torch_engine import _jax_model
from tests.test_torch_predict import REACH, _dilate

CLASSES = ['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum']
OUT = [80, 80]
NEAR = 1e-4


def _image(h, w, seed):
    """(h, w, 3) uint8 RGB with a dark disc (a lumen) in a bright ring."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    g = 200 * np.exp(-((r - min(h, w) / 4) / 6) ** 2) + rng.normal(40, 15, (h, w))
    return np.clip(np.stack([g, 0.8 * g + 20, 0.5 * g], -1), 0, 255).astype(np.uint8)


def write_image_dir(root: str) -> list:
    """The directory of every image kind; returns the file names."""
    os.makedirs(root, exist_ok=True)
    Image.fromarray(_image(70, 90, 1)).save(os.path.join(root, 'a_rgb.png'))
    rgba = np.concatenate([_image(64, 50, 2), np.random.default_rng(2).integers(
        0, 256, (64, 50, 1), dtype=np.uint8)], -1)
    rgba[:10, :, 3] = 0
    rgba[-10:, :, 3] = 255
    Image.fromarray(rgba, 'RGBA').save(os.path.join(root, 'b_rgba.png'))
    Image.fromarray(_image(33, 47, 3)[..., 0]).save(os.path.join(root, 'c_gray.png'))
    pal = Image.fromarray(_image(100, 80, 4)).quantize(colors=37)
    pal.save(os.path.join(root, 'd_palette.png'))
    cv2.imwrite(os.path.join(root, 'e_colour.jpg'), _image(61, 83, 5)[..., ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    cv2.imwrite(os.path.join(root, 'f_gray.jpeg'), _image(40, 40, 6)[..., 1])
    with open(os.path.join(root, 'notes.txt'), 'w') as f:   # not an image: skipped
        f.write('x')
    return ['a_rgb', 'b_rgba', 'c_gray', 'd_palette', 'e_colour', 'f_gray']


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('models'))
    for seed, (name, classes) in enumerate((('LM', ['Lumen']),
                                            ('FC_LC', ['Lipid core', 'Fibrous cap']),
                                            ('VV', ['Vasa vasorum']))):
        model_dir = initialize_model_dir(os.path.join(root, name), classes, 'Unet',
                                         'resnet18', input_size=64, seed=seed)
        path = os.path.join(model_dir, 'weights.ckpt')
        variables = load_weights(path)
        head = variables['params']['head']['Conv_0']
        head['kernel'] = head['kernel'] / 20
        head['bias'] = np.random.default_rng(seed).normal(0, 0.5, head['bias'].shape).astype(
            np.float32)
        save_weights(path, variables['params'], variables['batch_stats'])
    return root


def _jax_image_probabilities(models_dir, data_dir):
    """(N, 80, 80, 4) probabilities that octseg's image path thresholds:
    its preprocessing and forward with sigmoid in place of the threshold."""
    from octseg.core.registry import CLASS_IDS

    images, _masks, _names = jax_utils.data_processing(data_dir, data_dir + '_unused', OUT)
    probs = np.full((len(images), *OUT, 4), np.nan, np.float32)
    for name in ('LM', 'FC_LC', 'VV'):
        apply, variables, cfg = _jax_model(os.path.join(models_dir, name))
        s = cfg['input_size']
        x = np.stack([jax_utils.preprocessing_img(img.copy(), s) for img in images])
        x = jnp.asarray(x, jnp.float32)
        if cfg.get('normalize', False):
            x = jax_normalize(x)
        p = np.asarray(jax_resize_bilinear(1 / (1 + jnp.exp(-apply(variables, x))), OUT))
        for cls in CLASSES:
            if MODELS_META[cls]['model_dir'] == name:
                probs[..., CLASS_IDS[cls] - 1] = p[..., MODELS_META[cls]['index']]
    return probs


def test_image_directory_predict_matches_jax(models_dir, tmp_path, monkeypatch):
    monkeypatch.setattr('octseg.core.config.setup_logging', lambda *a, **k: None)
    data_dir = str(tmp_path / 'images')
    names = write_image_dir(data_dir)
    keys = dict(data_dir=data_dir, models_dir=models_dir, output_size=OUT, block_size=4,
                classes=CLASSES)
    jax_predict.main(JaxConfig(save_dir=str(tmp_path / 'jax'), device='auto', **keys))
    result = predict.main(Config(save_dir=str(tmp_path / 'torch'), device='cpu', **keys))
    assert result['frames'] == len(names)
    assert set(result['seconds']) == {'decode', 'engine', 'render', 'total'}
    assert set(result['chunks']) == {'LM', 'FC_LC', 'VV'}
    files = sorted(os.listdir(tmp_path / 'jax'))
    assert files == sorted(os.listdir(tmp_path / 'torch'))
    assert files == sorted(f'{n}_{k}.png' for n in names for k in ('mask', 'overlay'))

    probs = _jax_image_probabilities(models_dir, data_dir)
    near = (np.abs(probs - 0.5) < NEAR).any(axis=-1)
    assert near.mean() < 1e-3
    for i, name in enumerate(names):
        png = {}
        for kind, allowed in (('mask', near[i]), ('overlay', _dilate(near[i], REACH))):
            want = np.asarray(Image.open(tmp_path / 'jax' / f'{name}_{kind}.png'))
            got = np.asarray(Image.open(tmp_path / 'torch' / f'{name}_{kind}.png'))
            assert got.shape == want.shape == (*OUT, 3)
            differ = (got != want).any(axis=-1)
            assert not (differ & ~allowed).any(), f'{name}_{kind} differs away from p = 0.5'
            png[kind] = (got, want)
        if np.array_equal(*png['mask']):   # equal masks: equal overlays
            np.testing.assert_array_equal(*png['overlay'], err_msg=name)


@pytest.mark.parametrize('mode', ['L', 'RGB', 'RGBA', 'P'])
@pytest.mark.parametrize('src,dst', [((37, 53), (80, 80)), ((100, 90), (64, 48)),
                                     ((704, 704), (1000, 1000)), ((50, 40), (13, 77))])
def test_pil_resize_matches_pillow(mode, src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    h, w = src
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[..., 3] = np.where(rng.random((h, w)) < 0.2, 0,
                          np.where(rng.random((h, w)) < 0.2, 255, px[..., 3]))
    palette = None
    if mode == 'P':
        img = Image.frombytes('P', (w, h), px[..., 0].tobytes())
        img.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        palette = np.asarray(img.getpalette(), np.uint8).reshape(-1, 3)
        ours = PilImage('P', px[..., 0], palette)
    else:
        arr = {'L': px[..., 0], 'RGB': px[..., :3], 'RGBA': px}[mode]
        img = Image.fromarray(arr, mode)
        ours = PilImage(mode, arr)
    want = img.resize(dst[::-1])
    got = pil_resize(ours, dst[::-1])
    assert got.mode == want.mode
    np.testing.assert_array_equal(got.pixels, np.asarray(want))
    np.testing.assert_array_equal(got.to_rgb(), np.asarray(want.convert('RGB')))


def test_open_image_and_preprocessing_match_pil_and_cv2(tmp_path):
    names = write_image_dir(str(tmp_path))
    for f in sorted(os.listdir(tmp_path)):
        if not f.endswith(('.png', '.jpg', '.jpeg')):
            continue
        path = str(tmp_path / f)
        img = Image.open(path)
        ours = open_image(path)
        assert ours.mode == img.mode, f
        np.testing.assert_array_equal(ours.pixels, np.asarray(img), err_msg=f)
        np.testing.assert_array_equal(ours.to_rgb(), np.asarray(img.convert('RGB')), err_msg=f)
        for size in (64, 96):
            np.testing.assert_array_equal(utils.preprocessing_img(ours, size),
                                          jax_utils.preprocessing_img(img.copy(), size),
                                          err_msg=f)
    images, masks, got_names = utils.data_processing(str(tmp_path), str(tmp_path / 's'), [30, 20])
    want_images, want_masks, want_names = jax_utils.data_processing(
        str(tmp_path), str(tmp_path / 's2'), [30, 20])
    assert got_names == want_names == names
    for ours, theirs in zip(images, want_images):
        assert ours.size == theirs.size == (20, 30)
        np.testing.assert_array_equal(ours.pixels, np.asarray(theirs))
    for m, wm in zip(masks, want_masks):
        assert m.dtype == wm.dtype == np.float64 and m.shape == wm.shape == (30, 20, 4)
    one, _, one_name = utils.data_processing(str(tmp_path / 'e_colour.jpg'), str(tmp_path / 's'),
                                             [30, 20])
    assert one_name == ['e_colour'] and len(one) == 1


def _mode_file(tmp_path, mode):
    path = str(tmp_path / ('x.jpg' if mode == 'CMYK' else 'x.png'))
    rng = np.random.default_rng(9)
    if mode == 'CMYK':
        Image.fromarray(rng.integers(0, 256, (20, 24, 4), dtype=np.uint8), 'CMYK').save(path)
    elif mode == 'I;16':
        Image.fromarray(rng.integers(0, 65536, (20, 24), dtype=np.uint16)).save(path)
    elif mode == '1':
        Image.fromarray(rng.random((20, 24)) > 0.5).save(path)
    else:
        Image.fromarray(rng.integers(0, 256, (20, 24, 2), dtype=np.uint8), 'LA').save(path)
    return path


# the modes octseg's image path meets beyond L, P, RGB and RGBA, and whether
# its data_processing + preprocessing_img accepts them (cv2 rejects a bool
# and a two-channel array)
OCTSEG_ACCEPTS = {'I;16': True, 'CMYK': True, '1': False, 'LA': False}


@pytest.mark.parametrize('mode', list(OCTSEG_ACCEPTS))
def test_other_modes_raise_with_the_gap_written_down(tmp_path, mode):
    path = _mode_file(tmp_path, mode)
    assert Image.open(path).mode == mode
    try:
        img = Image.open(path).resize((16, 16))
        jax_utils.preprocessing_img(img, 16)
        accepted = True
    except cv2.error:
        accepted = False
    assert accepted == OCTSEG_ACCEPTS[mode]
    with pytest.raises(NotImplementedError, match='ROADMAP.md, "JPEG forms and image modes'):
        open_image(path)


def test_file_and_dir_lists_match_jax(tmp_path):
    for rel in ('b/x.PNG', 'b/y.jpg', 'a/z.png', 'a/sub/w.png', 'c/IMG1.tiff', 'c/IMG2.png'):
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        (tmp_path / rel).write_bytes(b'')
    for args in (([str(tmp_path)], ['.png', '.jpg']), (str(tmp_path / 'c'), '.png', 'IMG'),
                 ([str(tmp_path / 'a'), str(tmp_path / 'b')], ['.png'])):
        assert utils.get_file_list(*args) == jax_utils.get_file_list(*args)
    for kw in ({}, {'include_dirs': ['a', 'c']}, {'exclude_dirs': ['b']}):
        assert utils.get_dir_list(str(tmp_path), **kw) == jax_utils.get_dir_list(str(tmp_path),
                                                                                  **kw)
