"""octseg_torch's CAM explainability against octseg's, on the CPU.

- All nine methods on Unet/resnet18 at 64 px (classes 2, octseg's flax
  initialization from seed 2, which leaves no method's map blank, carried
  into the port through the weights bridge), and three on PSPNet/resnet18,
  whose default level is 3: every map within CAM_ATOL of octseg's on
  [0, 1], AblationCAM's within ABLATION_ATOL. Measured: at most 1.4e-6,
  except GradCAM++ on PSPNet at 2.8e-4 (its alpha divides by a sum of
  cubed gradients) and AblationCAM on Unet at 1.24e-3: its weights are
  (base - score) / base, a difference of two near-equal float32 sums of
  logits, each of which the two packages' convolutions round differently.
- The JET table equals cv2.applyColorMap(COLORMAP_JET) then BGR -> RGB, bit
  for bit, and the overlay equals octseg's.
- The driver on a 2-image directory: metrics.csv equal to octseg's, and
  every PNG equal to octseg's as pixels (octseg writes through cv2, the port
  through its own writer).
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octseg.core.config import Config as JaxConfig
from octseg.explain import visualize_activation_maps as jax_driver
from octseg.explain.cam import CAMProcessor as JaxCAMProcessor
from octseg.models import create_model as jax_create_model
from octseg.train.checkpoint import initialize_model_dir
from octseg_torch.core.config import Config
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.explain import CAM_METHODS, CAMProcessor, visualize_activation_maps
from octseg_torch.explain.cam import JET_RGB
from octseg_torch.models import create_model
from octseg_torch.models.convert import variables_to_state_dict

# This module keeps torch's default thread count, not tests/torch_threads.py's
# share: the port's GradCAM++ map misses octseg's by 0.048 at 1 or 2 threads
# (ROADMAP.md C, "GradCAM++ parity depends on torch's thread count").

CAM_ATOL = 1e-3
ABLATION_ATOL = 1e-2
SIZE = 64


def _pair(arch, seed=2):
    """(octseg model, variables, port model) with octseg's initialization."""
    model = jax_create_model(arch, 'resnet18', classes=2)
    variables = model.init({'params': jax.random.PRNGKey(seed), 'dropout': jax.random.PRNGKey(0)},
                           jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    state = variables_to_state_dict(jax.tree.map(np.asarray, variables), arch, 'resnet18')
    port = create_model(arch, 'resnet18', classes=2)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model, variables, port.eval()


@pytest.mark.parametrize('arch,methods', [
    ('Unet', CAM_METHODS), ('PSPNet', ['GradCAM', 'GradCAMPlusPlus', 'EigenCAM'])])
def test_every_method_within_the_tolerance_of_octsegs(arch, methods):
    model, variables, port = _pair(arch)
    x = np.random.default_rng(2).normal(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    logits = np.asarray(model.apply(variables, x[None], train=False))[0]
    mask = (logits[..., 0] > np.median(logits[..., 0])).astype(np.float32)
    theirs = JaxCAMProcessor(model, variables)   # its jitted encode/decode, shared
    level = 3 if arch == 'PSPNet' else 5
    assert theirs.level == level
    for method in methods:
        theirs.method = method
        want = theirs.extract_activation_map(x, 0, mask)
        ours = CAMProcessor(port, method=method)
        assert ours.level == level
        got = ours.extract_activation_map(x, 0, mask)
        assert got.shape == want.shape == (SIZE, SIZE) and got.dtype == want.dtype
        assert want.max() > 0.5, method   # a blank map compares nothing
        atol = ABLATION_ATOL if method == 'AblationCAM' else CAM_ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=method)
        img = np.random.default_rng(3).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
        np.testing.assert_array_equal(CAMProcessor.overlay_activation_map(img, want),
                                      JaxCAMProcessor.overlay_activation_map(img, want))


def test_jet_table_is_cv2s():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)
    np.testing.assert_array_equal(JET_RGB, cv2.cvtColor(lut, cv2.COLOR_BGR2RGB)[:, 0])


def test_unknown_method_raises():
    with pytest.raises(ValueError, match='Unknown CAM method'):
        CAMProcessor(create_model('Unet', 'resnet18'), method='ScoreCAM')


def test_driver_writes_what_octsegs_writes(tmp_path):
    method = 'GradCAM'
    classes = ['Lumen', 'Fibrous cap']
    model_dir = initialize_model_dir(str(tmp_path / 'model'), classes, input_size=SIZE, seed=2)
    fold = str(tmp_path / 'fold')
    make_synth_fold(fold, n_train=2, n_test=1, size=80, seed=4)
    common = dict(model_dir=model_dir, data_dir=os.path.join(fold, 'train'), classes=None,
                  cam_method=method, map_threshold=0.5, feature_level=5)
    jax_driver.main(JaxConfig(common, save_dir=str(tmp_path / 'jax')))
    rows = visualize_activation_maps.main(Config(common, save_dir=str(tmp_path / 'port'),
                                                 device='cpu'))
    assert len(rows) == 2 * len(classes)
    want_dir, got_dir = tmp_path / 'jax' / method, tmp_path / 'port' / method
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 2 * 2 * 5 + 1
    with open(want_dir / 'metrics.csv') as f, open(got_dir / 'metrics.csv') as g:
        assert g.read() == f.read()
    for name in names:
        if name.endswith('.png'):
            want = cv2.imread(str(want_dir / name), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(got_dir / name), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(got, want, err_msg=name)
