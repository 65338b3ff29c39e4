"""octseg_torch's inference service and client against the JAX package's.

The port's server runs on the CPU with three 64 px Unet/resnet18 model dirs
(LM, FC_LC, VV: tests/test_torch_engine.py's ``make_models_dir``, heads
softened as chip_smoke.py's ``soften_heads`` does so that the masks are
neither empty nor full) on small DICOM pullbacks. It must speak octseg's
wire format: ``encode_block`` bytes and ``Metrics.render()`` text equal
octseg's; octseg's ``decode_block`` reads the streamed blocks, which equal
the server engine's ``segment_pullback`` exactly; the quant payload equals
octseg's ``quantify_frame`` math on those masks (Python floats, ``==``);
octseg's own client in quant mode writes the same ``quant.json`` as the
port's. The port client's PNGs are byte-identical to a local port predict
run with the same engine settings. Then the error paths.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import octseg
from octseg.analyze.analysis import quantify_frame as jax_quantify_frame
from octseg.infer import client as jax_client
from octseg.infer import serve as jax_serve
from octseg_torch.core.config import Config
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.data import dicom
from octseg_torch.infer import client, predict, serve
from tests.test_torch_engine import CLASSES, make_models_dir
from tests.torch_threads import torch_threads_share  # noqa: F401

OUT = [48, 48]
BLOCK = 4   # five frames stream as two blocks


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    from chip_smoke import soften_heads

    root = make_models_dir(str(tmp_path_factory.mktemp('serve_models')))
    soften_heads(root)
    return root


def server_config(models_dir, **keys):
    return Config(dict(dict(host='127.0.0.1', port=0, models_dir=models_dir, output_size=OUT,
                            max_queued=0, block_size=BLOCK, classes=CLASSES, device='cpu',
                            bf16=False), **keys))


@pytest.fixture(scope='module')
def server(models_dir):
    httpd = serve.serve(server_config(models_dir), block=False)
    yield httpd
    httpd.shutdown()
    httpd.server_close()


def _url(server, path):
    host, port = server.server_address
    return f'http://{host}:{port}{path}'


def _pullback(tmp_path, n=5, size=64, seed=0, name='IMG001'):
    frames = np.random.default_rng(seed).integers(0, 255, (n, size, size), dtype=np.uint8)
    path = str(tmp_path / name)
    dicom.dcmwrite(path, frames)
    return frames[..., None], path


def _post(server, path, body, headers=None):
    req = urllib.request.Request(_url(server, path), data=body, method='POST',
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=300)


@pytest.mark.parametrize('shape', [(3, 17, 23, 4), (1, 5, 7, 4), (2, 48, 48, 4)])
def test_encode_block_bytes_equal_octseg(shape):
    masks = (np.random.default_rng(sum(shape)).random(shape) > 0.6).astype(np.float32)
    rec = serve.encode_block(masks)
    assert rec == jax_serve.encode_block(masks)
    np.testing.assert_array_equal(serve.decode_block(rec, *shape[:3]), masks)
    np.testing.assert_array_equal(jax_serve.decode_block(rec, *shape[:3]), masks)


def test_metrics_render_equals_octseg():
    ours, theirs = serve.Metrics(), jax_serve.Metrics()
    for m in (ours, theirs):
        for endpoint, status in (('pullback', 200), ('pullback', 200), ('healthz', 200),
                                 ('pullback', 503), ('other', 404)):
            m.count(endpoint, status)
        m.frames_total = 42
        m.request_seconds_sum = 3.14159
        m.busy, m.admitted, m.rejected_total = 1, 2, 1
    assert ours.render() == theirs.render()


def test_healthz(server):
    with urllib.request.urlopen(_url(server, '/healthz')) as r:
        health = json.loads(r.read())
    assert health == {'status': 'ok', 'platform': 'cpu', 'devices': 1,
                      'models': ['FC_LC', 'LM', 'VV'], 'classes': CLASSES, 'output_size': OUT}


def _stream(server, body):
    with _post(server, '/v1/pullback', body) as r:
        assert r.status == 200 and r.headers['Content-Type'] == 'application/x-ndjson'
        return [json.loads(ln) for ln in r.read().splitlines()]


def test_masks_stream_read_by_octseg_equals_engine(server, tmp_path):
    frames, path = _pullback(tmp_path)
    with open(path, 'rb') as f:
        lines = _stream(server, f.read())
    header, blocks, end = lines[0], lines[1:-1], lines[-1]
    assert header == {'type': 'header', 'frames': 5, 'height': 48, 'width': 48,
                      'classes': CLASSES, 'encoding': 'packbits', 'channel_order': list(CLASS_IDS)}
    assert end['type'] == 'end' and end['frames'] == 5
    assert [(b['type'], b['start'], b['count']) for b in blocks] == [('block', 0, 4),
                                                                     ('block', 4, 1)]
    got = np.zeros((5, *OUT, 4), np.float32)
    for b in blocks:
        got[b['start']:b['start'] + b['count']] = jax_serve.decode_block(
            b, b['count'], header['height'], header['width'])
    want = server.octseg_state.engine.segment_pullback(frames, OUT)
    np.testing.assert_array_equal(got, want)
    with urllib.request.urlopen(_url(server, '/metrics')) as r:
        text = r.read().decode()
    assert 'octseg_requests_total{endpoint="pullback",status="200"}' in text
    assert 'octseg_busy 0' in text and 'octseg_queued 0' in text


def test_jpeg_pullback_streams(server):
    """The upload is read by predict's ``load_pullback_frames``: a JPEG
    Baseline pullback streams like a native one."""
    path = os.path.join(octseg.PROJECT_DIR, 'tests', 'torch_fixtures', 'jpeg', 'pullback.dcm')
    with open(path, 'rb') as f:
        lines = _stream(server, f.read())
    header, end = lines[0], lines[-1]
    assert header['frames'] == end['frames'] == 16
    got = np.concatenate([serve.decode_block(b, b['count'], *OUT) for b in lines[1:-1]])
    want = server.octseg_state.engine.segment_pullback(predict.load_pullback_frames(path), OUT)
    np.testing.assert_array_equal(got, want)


def test_quant_payload_equals_octseg_math(server, tmp_path):
    frames, path = _pullback(tmp_path, seed=1)
    with open(path, 'rb') as f, _post(server, '/v1/pullback?format=quant', f.read()) as r:
        payload = json.loads(r.read())
    masks = server.octseg_state.engine.segment_pullback(frames, OUT).astype(np.uint8)
    ratio = max(1, OUT[0] * 150 // 1000)
    assert payload['frames'] == 5 and payload['ratio'] == ratio and payload['output_size'] == OUT
    counted = 0
    for class_name in CLASSES:
        ch = CLASS_IDS[class_name] - 1
        slices = [i for i in range(5) if masks[i, :, :, ch].any() and not masks[i, :, :, ch].all()]
        obj = payload['objects'][class_name]
        assert obj['slice'] == slices
        ids, last = [], None
        for i in slices:
            ids.append(0 if last is None else ids[-1] + (i != last + 1))
            last = i
        assert obj['object_id'] == ids
        for row, idx in enumerate(slices):
            q = jax_quantify_frame(masks[idx, :, :, ch] * 255, ratio)
            assert (obj['area'][row], obj['thickness_mean'][row], obj['thickness_min'][row]) == (
                q['area'], q['thickness_mean'], q['thickness_min'])
        counted += len(slices)
    assert counted >= 4, 'too few channels hold both values for the check to mean much'
    # the Python tracer gives the same payload from the same masks
    assert serve.quantify_blocks([(0, masks)], 5, CLASSES, OUT, native=False) == payload


def test_octseg_client_quant_equals_port_client(server, tmp_path):
    _frames, path = _pullback(tmp_path, seed=2)
    url = 'http://%s:%d' % server.server_address
    keys = dict(server_url=url, dcm_path=path, format='quant', classes=CLASSES)
    assert jax_client.run(octseg.core.config.Config(save_dir=str(tmp_path / 'jax'), **keys)) == 5
    assert client.run(Config(save_dir=str(tmp_path / 'torch'), **keys)) == 5
    with open(tmp_path / 'jax' / 'quant.json', 'rb') as a, \
            open(tmp_path / 'torch' / 'quant.json', 'rb') as b:
        assert a.read() == b.read()


def test_client_masks_equal_local_predict(server, models_dir, tmp_path):
    _frames, path = _pullback(tmp_path, n=6, seed=3, name='IMG009')
    url = 'http://%s:%d' % server.server_address
    assert client.run(Config(server_url=url, dcm_path=path, save_dir=str(tmp_path / 'client'),
                             format='masks', classes=CLASSES, device='cpu')) == 6
    predict.main(Config(data_dir=path, models_dir=models_dir, save_dir=str(tmp_path / 'local'),
                        output_size=OUT, classes=CLASSES, block_size=BLOCK, device='cpu'))
    names = sorted(os.listdir(tmp_path / 'client'))
    assert names == sorted(os.listdir(tmp_path / 'local'))
    assert len(names) == 12 and 'IMG009_1_overlay.png' in names and 'IMG009_6_mask.png' in names
    for name in names:
        with open(tmp_path / 'client' / name, 'rb') as a, open(tmp_path / 'local' / name,
                                                              'rb') as b:
            assert a.read() == b.read(), name


def test_admission_control_503(server, tmp_path):
    _frames, path = _pullback(tmp_path, n=2)
    with open(path, 'rb') as f:
        body = f.read()
    state = server.octseg_state
    assert state.admit()   # an in-flight job
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, '/v1/pullback', body)
        assert e.value.code == 503 and e.value.headers['Retry-After'] == '10'
    finally:
        state.release()
    assert _stream(server, body)[-1]['type'] == 'end'
    with urllib.request.urlopen(_url(server, '/metrics')) as r:
        text = r.read().decode()
    assert 'octseg_requests_total{endpoint="pullback",status="503"} 1' in text
    assert 'octseg_rejected_total 1' in text


@pytest.mark.parametrize('path', ['/v1/pullback', '/v1/pullback?format=xml', '/v1/nope'])
def test_refusals_of_large_uploads_reach_the_client(server, path):
    """A refusal sent before the upload is read still reaches a client that
    sends its whole 32 MB upload first: the server drops the body before it
    answers (octseg's server closes unread, which resets the connection)."""
    state = server.octseg_state
    assert state.admit()   # the one slot (max_queued 0) is taken
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, path, b'\0' * (32 << 20))
    finally:
        state.release()
    assert e.value.code == {'/v1/pullback': 503, '/v1/pullback?format=xml': 400,
                            '/v1/nope': 404}[path]


def test_bad_requests(server, monkeypatch):
    def code(method, path, body=None):
        req = urllib.request.Request(_url(server, path), data=body, method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        return e.value.code

    assert code('POST', '/v1/pullback?format=xml', b'x') == 400
    assert code('POST', '/v1/nope', b'x') == 404
    assert code('GET', '/nope') == 404
    assert code('POST', '/v1/pullback', b'') == 411
    monkeypatch.setattr(serve, 'MAX_BODY_BYTES', 8)
    assert code('POST', '/v1/pullback', b'0123456789') == 413
    monkeypatch.undo()
    assert code('POST', '/v1/pullback', b'not a dicom') == 500
    with urllib.request.urlopen(_url(server, '/healthz')) as r:
        assert json.loads(r.read())['status'] == 'ok'


def test_failure_mid_stream_truncates_and_the_client_raises(server, tmp_path, monkeypatch):
    """After the 200 is on the wire a failure closes the stream without its
    end record; both clients raise instead of exiting with partial PNGs."""
    engine = server.octseg_state.engine
    real = engine.iter_pullback

    def failing(frames, output_size):
        it = real(frames, output_size)
        yield next(it)
        raise RuntimeError('device lost')

    monkeypatch.setattr(engine, 'iter_pullback', failing)
    _frames, path = _pullback(tmp_path, seed=4)
    url = 'http://%s:%d' % server.server_address
    with pytest.raises(RuntimeError, match='stream truncated: rendered 4 of 5'):
        client.run(Config(server_url=url, dcm_path=path, save_dir=str(tmp_path / 'o'),
                          classes=CLASSES, device='cpu'))
    with open(path, 'rb') as f:
        lines = _stream(server, f.read())
    assert [ln['type'] for ln in lines] == ['header', 'block']


def test_client_raises_on_truncated_stream(tmp_path, monkeypatch):
    _frames, path = _pullback(tmp_path, n=2)

    def fake_stream(server_url, dcm_path, fmt='masks', timeout=3600.0):
        yield {'type': 'header', 'frames': 2, 'height': 32, 'width': 32, 'classes': [],
               'encoding': 'packbits'}

    monkeypatch.setattr(client, 'stream_pullback', fake_stream)
    cfg = Config(server_url='http://x', dcm_path=path, save_dir=str(tmp_path / 'out'),
                 format='masks', classes=[], device='cpu')
    with pytest.raises(RuntimeError, match='truncated'):
        client.run(cfg)


def test_int8_raises_before_any_model_loads(models_dir, monkeypatch):
    def no_model(self, name):
        raise AssertionError(f'model {name} loaded')

    monkeypatch.setattr(serve.InferenceEngine, '_bundle', no_model)
    with pytest.raises(NotImplementedError, match='int8: true is not ported.*ROADMAP.md'):
        serve.serve(server_config(models_dir, int8=True), block=False)


def test_serve_config_reads_unchanged():
    from octseg_torch.core.config import load_config

    cfg = load_config('serve')
    assert (cfg.bf16, cfg.int8, cfg.block_size, cfg.output_size, cfg.spool_dir,
            cfg.max_queued) == (True, False, 128, [1000, 1000], None, 1)
    assert cfg.classes == CLASSES and cfg.host == '127.0.0.1' and cfg.port == 7884


def test_client_quant_mode_imports_no_engine(tmp_path):
    code = (
        "import sys, tempfile\n"
        "import octseg_torch.infer.client as client\n"
        "from octseg_torch.core.config import Config\n"
        "def fake(server_url, dcm_path, fmt='masks', timeout=0):\n"
        "    yield {'frames': 1, 'ratio': 9, 'objects': {}}\n"
        "client.stream_pullback = fake\n"
        "assert client.run(Config(server_url='http://x', dcm_path='/dev/null',\n"
        "                  save_dir=tempfile.mkdtemp(), format='quant', classes=[])) == 1\n"
        "loaded = [m for m in sys.modules if m.startswith(('octseg_torch.infer.engine',\n"
        "          'octseg_torch.infer.predict', 'octseg_torch.infer.serve',\n"
        "          'octseg_torch.models'))]\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ)
    env['PYTHONPATH'] = octseg.PROJECT_DIR
    proc = subprocess.run([sys.executable, '-c', code], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
