"""octseg_torch's analyze app (analysis, figures, HTTP app) against octseg's.

A synthetic demo work dir, made from a seed with numpy (the reference's
data/app/demo is not in the repository): 9 frames of 120 px, PNG frames and
(H, W, 4) mask TIFFs whose objects span frames, skip frames and hold holes
and several components. On it:

- ``get_analysis`` (demo mode) equals octseg's: the ratio, the image names
  and every trace, floats compared with ``==``, the base64 masks decoded;
- ``frame_contours`` equals octseg's JSON on every frame;
- the figures' plotted data equals octseg's instance runs and matplotlib's
  ``boxplot_stats``, and each figure is an SVG document;
- ``get_img_show`` decodes to octseg's PNG pixel for pixel;
- the port's app answers each of octseg's routes as octseg's app does on
  the same work dir (the plots as SVG where octseg serves PNG; a malformed
  upload 400 where octseg answers 500), and serves afterwards;
- ``_run_inference_into`` at 64 px with three Unet/resnet18 model dirs
  (grayscale and RGB DICOMs) writes the viewer PNGs octseg writes and the
  masks of the port's own engine (held to octseg's in
  tests/test_torch_engine.py).

Tolerance: none anywhere.
"""

import base64
import json
import os
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest

from octseg.analyze import analysis as jax_analysis
from octseg.analyze import figures as jax_figures
from octseg.core.config import Config as JaxConfig
from octseg.data.tiffio import write_tiff
from octseg_torch.analyze import analysis, app, figures
from octseg_torch.core.config import Config
from octseg_torch.data import dicom
from octseg_torch.data.tiffio import read_tiff
from tests.test_torch_engine import CLASSES, make_models_dir
from tests.torch_threads import torch_threads_share  # noqa: F401

SIDE, N_FRAMES = 120, 9
# frames holding each class (channel = class id - 1): runs that span and skip
PRESENT = {0: range(0, 6), 1: [1, 2, 3, 5, 6, 7, 8], 2: [2, 4], 3: [0, 1, 2, 7, 8]}


def _mask(rng, frame: int) -> np.ndarray:
    yy, xx = np.mgrid[:SIDE, :SIDE]
    m = np.zeros((SIDE, SIDE, 4), np.uint8)
    for ch, frames in PRESENT.items():
        if frame not in frames:
            continue
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.integers(20, 100, 2)
            r = int(rng.integers(6, 24))
            d = (yy - cy) ** 2 + (xx - cx) ** 2
            m[..., ch][d < r * r] = 255
            if r > 12:
                m[..., ch][d < (r // 3) ** 2] = 0   # a hole
    return m


@pytest.fixture(scope='module')
def demo_dir(tmp_path_factory):
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp('demo')
    (root / 'img').mkdir()
    (root / 'mask').mkdir()
    for i in range(N_FRAMES):
        name = f'frame_{i + 1:03d}'
        cv2.imwrite(str(root / 'img' / f'{name}.png'),
                    rng.integers(0, 256, (SIDE, SIDE, 3), dtype=np.uint8))
        write_tiff(str(root / 'mask' / f'{name}.tiff'), _mask(rng, i))
    return str(root)


@pytest.fixture(scope='module')
def analyses(demo_dir):
    return (jax_analysis.get_analysis(None, 'demo', demo_dir=demo_dir),
            analysis.get_analysis(None, 'demo', demo_dir=demo_dir))


def _decoded(b64: str) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8), cv2.IMREAD_UNCHANGED)


def test_get_analysis_equals_octseg(analyses):
    want, got = analyses
    assert got['ratio'] == want['ratio'] == SIDE * 150 // 1000
    assert got['images'] == want['images'] and got['work_dir'] == want['work_dir']
    assert list(got['objects']) == list(want['objects'])
    for name, obj in want['objects'].items():
        mine = got['objects'][name]
        assert set(mine) == set(obj)
        for key in obj:
            if key != 'masks':
                assert mine[key] == obj[key], (name, key)
        assert len(mine['masks']) == len(obj['masks'])
        for a, b in zip(mine['masks'], obj['masks']):
            np.testing.assert_array_equal(_decoded(a), _decoded(b))
    assert got['objects']['Fibrous cap']['object_id'] == [0, 0, 0, 1, 1, 1, 1]
    json.dumps(got)


def test_frame_contours_equal_octseg(analyses):
    want, got = analyses
    found = 0
    for num in range(-1, N_FRAMES + 1):
        mine = analysis.frame_contours(got, num)
        assert mine == jax_analysis.frame_contours(want, num)
        found += len(mine['objects'])
    assert found >= 20
    assert analysis.frame_contours(got, 3, native=False) == jax_analysis.frame_contours(want, 3)


def test_figures_plot_octseg_data(analyses):
    from matplotlib.cbook import boxplot_stats

    want, got = analyses
    runs = [(c, r) for c, obj in want['objects'].items()
            for r in jax_figures._instance_runs(obj)]
    assert [(d['class'], d['slices']) for d in figures.object_map_data(got)] == runs
    classes = ['Lumen', 'Fibrous cap', 'Vasa vasorum']
    traces = [(c, [s for s, _a in r], [a for _s, a in r])
              for c, obj in want['objects'].items() if c in classes
              for r in jax_figures._instance_runs(obj, with_area=True) if len(r) >= 3]
    assert [(d['class'], d['slices'], d['areas'])
            for d in figures.trace_area_data(classes, got)] == traces
    boxes = figures.plot_area_data(classes, got)
    labels = [f'{c}, {i}' for c, obj in want['objects'].items() if c in classes
              for i, r in enumerate(jax_figures._instance_runs(obj, with_area=True), 1)
              if len(r) >= 3]
    assert [b['label'] for b in boxes] == labels and len(boxes) >= 3
    for b, ref in zip(boxes, boxplot_stats([t[2] for t in traces])):
        for key in ('mean', 'iqr', 'cilo', 'cihi', 'whishi', 'whislo', 'q1', 'med', 'q3'):
            assert b['stats'][key] == ref[key], key
        np.testing.assert_array_equal(b['stats']['fliers'], ref['fliers'])
    for doc in (figures.get_object_map(got), figures.get_trace_area(classes, got),
                figures.get_plot_area(classes, got)):
        assert ET.fromstring(doc).tag == '{http://www.w3.org/2000/svg}svg'


@pytest.mark.parametrize('samples', [[1.0, 2.0, 3.0], [5.0, 5.0, 5.0, 5.0],
                                     [1.0, 2.0, 2.5, 3.0, 40.0, -30.0, 2.2]])
def test_boxplot_stats_equal_matplotlib(samples):
    from matplotlib.cbook import boxplot_stats

    ref = boxplot_stats([samples])[0]
    got = figures.boxplot_stats(samples)
    for key in ('mean', 'iqr', 'cilo', 'cihi', 'whishi', 'whislo', 'q1', 'med', 'q3'):
        assert got[key] == ref[key], key
    np.testing.assert_array_equal(got['fliers'], ref['fliers'])


@pytest.mark.parametrize('num,classes,opacity', [(0, None, 20), (2, ['Lipid core'], 55),
                                                 (7, ['Lumen', 'Vasa vasorum'], 0)])
def test_img_show_equals_octseg(analyses, demo_dir, num, classes, opacity):
    want, got = analyses
    img_dir = os.path.join(demo_dir, 'img')
    a = jax_figures.get_img_show(want, img_dir, num, classes, opacity)
    b = figures.get_img_show(got, img_dir, num, classes, opacity)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR),
                                  cv2.imdecode(np.frombuffer(a, np.uint8), cv2.IMREAD_COLOR))


def _get(url, data=None):
    req = urllib.request.Request(url, data=data, method='POST' if data is not None else 'GET')
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers['Content-Type'], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers['Content-Type'], e.read()


@pytest.fixture(scope='module')
def servers(demo_dir):
    from octseg.analyze.app import serve as jax_serve

    cfg = dict(host='127.0.0.1', port=0, demo_dir=demo_dir, device='cpu')
    pair = (jax_serve(JaxConfig(cfg), block=False), app.serve(Config(cfg), block=False))
    yield ['http://%s:%d' % s.server_address for s in pair]
    for s in pair:
        s.shutdown()
        s.server_close()


def test_app_routes_answer_as_octseg(servers):
    jax_url, url = servers
    assert _get(f'{url}/')[2] == app._PAGE.encode()
    assert b'/object_map.svg?sid=' in app._PAGE.encode()
    sids = []
    for base in servers:
        status, ctype, body = _get(f'{base}/analyze?mode=demo', b'')
        assert status == 200 and ctype == 'application/json'
        sids.append(json.loads(body))
    assert sids[0]['n_frames'] == sids[1]['n_frames'] == N_FRAMES
    assert sids[0]['classes'] == sids[1]['classes']
    jsid, sid = sids[0]['sid'], sids[1]['sid']
    for route in ('contours.json?num=2', 'contours.json?num=99', 'metadata.json',
                  'base_frame.png?num=4', 'base_frame.png?num=99', 'frame.png?num=99',
                  'nope'):
        want = _get(f'{jax_url}/{route}&sid={jsid}' if '?' in route
                    else f'{jax_url}/{route}?sid={jsid}')
        got = _get(f'{url}/{route}&sid={sid}' if '?' in route else f'{url}/{route}?sid={sid}')
        assert got[:2] == want[:2], route
        if want[1] == 'application/json':
            assert json.loads(got[2]) == json.loads(want[2]), route
        else:
            assert got[2] == want[2], route
    want = _get(f'{jax_url}/frame.png?num=1&opacity=30&classes=Lumen&sid={jsid}')
    got = _get(f'{url}/frame.png?num=1&opacity=30&classes=Lumen&sid={sid}')
    assert got[:2] == want[:2] == (200, 'image/png')
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(got[2], np.uint8), 1),
                                  cv2.imdecode(np.frombuffer(want[2], np.uint8), 1))
    for plot in ('object_map', 'trace_area', 'plot_area'):
        assert _get(f'{jax_url}/{plot}.png?sid={jsid}&classes=Lumen')[:2] == (200, 'image/png')
        status, ctype, body = _get(f'{url}/{plot}.svg?sid={sid}&classes=Lumen')
        assert (status, ctype) == (200, 'image/svg+xml') and body.startswith(b'<svg')
    # the latest session without a sid; an unknown sid
    assert json.loads(_get(f'{url}/contours.json?num=0')[2]) == json.loads(
        _get(f'{url}/contours.json?num=0&sid={sid}')[2])
    assert _get(f'{url}/contours.json?sid=nope')[0] == _get(f'{jax_url}/contours.json?sid=x')[0]


def test_malformed_upload_is_refused_and_the_app_serves_on(servers):
    jax_url, url = servers
    garbage = b'\x00garbage\xff' * 100
    assert _get(f'{jax_url}/analyze?mode=inference', garbage)[0] == 500
    status, _ctype, body = _get(f'{url}/analyze?mode=inference', garbage)
    assert status == 400 and b'not a readable DICOM' in body
    assert _get(f'{url}/analyze?mode=inference', b'')[0] == 400
    assert _get(f'{url}/nope', b'')[0] == 404
    status, _ctype, body = _get(f'{url}/analyze?mode=demo', b'')
    assert status == 200 and json.loads(body)['n_frames'] == N_FRAMES


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    from chip_smoke import soften_heads

    root = make_models_dir(str(tmp_path_factory.mktemp('app_models')))
    soften_heads(root)
    return root


@pytest.mark.parametrize('mono', [True, False], ids=['gray', 'rgb'])
def test_run_inference_into_writes_the_engines_masks(models_dir, tmp_path, mono):
    import torch

    from octseg_torch.data.image import normalize_slice
    from octseg_torch.infer.engine import InferenceEngine

    rng = np.random.default_rng(int(mono))
    shape = (3, 64, 64) if mono else (3, 64, 64, 3)
    frames = rng.integers(0, 200, shape, dtype=np.uint8)
    dcm = str(tmp_path / 'IMG001')
    dicom.dcmwrite(dcm, frames)
    data = analysis.get_analysis(dcm, 'inference', models_dir=models_dir,
                                 temp_root=str(tmp_path / 'temp'), device='cpu')
    work = data['work_dir']
    assert data['ratio'] == 64 * 150 // 1000 and len(data['images']) == 3
    norm = np.stack([normalize_slice(f) for f in frames])
    norm = norm[..., None] if mono else norm
    with torch.no_grad():
        want = InferenceEngine(models_dir, CLASSES, device='cpu').segment_pullback(norm, [64, 64])
    for i in range(3):
        name = f'frame_{i + 1:03d}'
        np.testing.assert_array_equal(read_tiff(os.path.join(work, 'mask', f'{name}.tiff')),
                                      (want[i] * 255).astype(np.uint8))
        # octseg's viewer PNG: cv2.imwrite of the normalised frame's channel swap
        viewer = cv2.normalize(frames[i], None, 0, 255, cv2.NORM_MINMAX, cv2.CV_8U)
        viewer = (cv2.cvtColor(viewer, cv2.COLOR_GRAY2BGR) if mono
                  else cv2.cvtColor(viewer, cv2.COLOR_BGR2RGB))
        np.testing.assert_array_equal(cv2.imread(os.path.join(work, 'img', f'{name}.png')),
                                      viewer)
    assert any(o['slice'] for o in data['objects'].values())
