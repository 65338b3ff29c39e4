"""int8 inference through the port's entry points against octseg's.

Three 64 px Unet/resnet18 model dirs (tests/test_torch_engine.py's, heads
softened as in tests/test_torch_serve.py so that masks are neither empty
nor full) and 8 RGB frames, one engine block and one chunk on both sides:
octseg's activation scale spans its (sharded) block and the port's its
chunk, so both scale over the same 8 frames.

- The masks predict renders and the service streams with ``int8=true``
  equal octseg's int8 engine's masks, except at pixels whose
  fp32 probability lies within BAND of 0.5. Reason: a float32 activation
  that differs by an ulp between the two frameworks can round to the other
  int8 value at a .5 boundary, which moves the logits by about one
  quantization step of a layer (measured: 197 of the port engine's 86,016
  mask pixels differ from octseg's, all within 5.5e-3 of 0.5; int8 itself moves
  265 of octseg's pixels from its fp32 masks, all within 5.2e-3).
- ``evaluate_model(..., int8=True)`` equals octseg's within EVAL_TOL (exact
  evaluate holds 1e-5): the same flips can move a few pixels of a mask,
  and one pixel moves a sample's IoU by about one over its union (about
  1e-3 here), a sixth of that in the split's mean (measured: equal; int8
  itself moves the metrics 5.7e-4 from exact).
"""

import numpy as np
import pytest

from octseg.infer.engine import InferenceEngine as JaxEngine
from octseg.train.evaluate import evaluate_model as jax_evaluate_model
from octseg_torch.infer import serve
from octseg_torch.ops import quantize
from octseg_torch.train import evaluate
from tests.test_torch_engine import CLASSES, jax_probabilities, make_frames, make_models_dir
from tests.test_torch_evaluate import trained  # noqa: F401
from tests.test_torch_serve import _stream, server_config
from tests.torch_threads import torch_threads_share  # noqa: F401

OUT = (48, 56)
FRAMES = 8
BAND = 0.02
EVAL_TOL = 1e-3


@pytest.fixture(scope='module')
def models_dir(tmp_path_factory):
    from chip_smoke import soften_heads

    root = make_models_dir(str(tmp_path_factory.mktemp('int8_models')))
    soften_heads(root)
    return root


@pytest.fixture(scope='module')
def octseg_int8(models_dir):
    """octseg's int8 masks of the frames, and its fp32 probabilities."""
    frames = make_frames('rgb', n=FRAMES, seed=3)
    masks = JaxEngine(models_dir, CLASSES, block_size=FRAMES, int8=True).segment_pullback(
        frames, OUT)
    probs = jax_probabilities(models_dir, CLASSES, frames, OUT, 'prob_bilinear')
    # the fp32 engine's masks: the probabilities it thresholds, > 0.5
    return frames, masks, (probs > 0.5).astype(np.float32), probs


def _assert_within_band(got, want, probs):
    differ = got != want
    near = np.abs(probs - 0.5) < BAND
    assert not (differ & ~near).any(), (
        f'{int((differ & ~near).sum())} int8 mask pixels differ from octseg\'s with the fp32 '
        f'probability at least {BAND} from 0.5')
    return int(differ.sum())


def test_predict_int8_masks_equal_octsegs_away_from_one_half(models_dir, octseg_int8,
                                                             tmp_path, monkeypatch):
    """``predict.main`` with ``int8=true`` on a DICOM of the frames: the
    masks it renders (caught at ``render_mask_block``)."""
    from octseg_torch.core.config import Config
    from octseg_torch.data import dicom
    from octseg_torch.infer import predict

    frames, want, exact, probs = octseg_int8
    calls, rendered = [], np.zeros(want.shape, np.float32)
    real = quantize.quantized_conv
    monkeypatch.setattr(quantize, 'quantized_conv',
                        lambda conv, x, pads: calls.append(conv) or real(conv, x, pads))
    monkeypatch.setattr(predict, 'render_mask_block',
                        lambda frames, masks, start, *a, **k: rendered.__setitem__(
                            slice(start, start + masks.shape[0]), masks))
    path = str(tmp_path / 'IMG001')
    dicom.dcmwrite(path, frames)
    result = predict.main(Config(data_dir=path, models_dir=models_dir,
                                 save_dir=str(tmp_path / 'out'), output_size=list(OUT),
                                 classes=CLASSES, block_size=FRAMES, device='cpu', int8=True))
    assert result['frames'] == FRAMES and result['chunks'] == {'LM': 8, 'FC_LC': 8, 'VV': 8}
    assert len(calls) == 3 * 24
    _assert_within_band(rendered, want, probs)
    # int8 moved octseg's masks too: the comparison is not of two fp32 runs
    assert (want != exact).any()


def test_served_int8_masks_equal_octsegs_away_from_one_half(models_dir, octseg_int8,
                                                            tmp_path):
    frames, want, _exact, probs = octseg_int8
    cfg = server_config(models_dir, int8=True, block_size=FRAMES, output_size=list(OUT))
    httpd = serve.serve(cfg, block=False)
    try:
        from octseg_torch.data import dicom

        path = str(tmp_path / 'IMG001')
        dicom.dcmwrite(path, frames)
        with open(path, 'rb') as f:
            lines = _stream(httpd, f.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    got = np.zeros(want.shape, np.float32)
    for b in lines[1:-1]:
        got[b['start']:b['start'] + b['count']] = serve.decode_block(b, b['count'], *OUT)
    _assert_within_band(got, want, probs)


def test_int8_evaluate_equals_octsegs(trained):  # noqa: F811
    model_dir, fold = trained
    got = evaluate.evaluate_model(model_dir, fold, batch_size=4, int8=True, device='cpu')
    want = jax_evaluate_model(model_dir, fold, batch_size=4, int8=True)
    assert list(got) == list(want)
    for cl in want:
        for k, v in want[cl].items():
            assert abs(got[cl][k] - v) <= EVAL_TOL, (cl, k, got[cl][k], v)
