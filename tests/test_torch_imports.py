"""octseg_torch's runtime imports torch, numpy and the standard library only.

The machine with the card has no jax, flax, optax, cv2, PIL, yaml or
msgpack, and the port must not lean on the JAX package: a clean interpreter
runs the port's CPU predict path on a tiny pullback and on an image
directory (a PNG and a JPEG, bf16), a CPU training epoch (augmentation
on) on a tiny synthetic fold, a DeepLabV3Plus forward (a dilated encoder)
and a GP-EI suggestion of the tuner after three observations, and must not
have loaded any of them (nor sklearn, which octseg's tuner fits its GP
with); an AST scan checks every import statement of the package and of
chip_smoke.py.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

import octseg

REPO = octseg.PROJECT_DIR
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'cv2', 'PIL', 'yaml', 'msgpack', 'octseg',
          'scipy', 'sklearn')

SCRIPT = r'''
import json, os, sys
import numpy as np
from octseg_torch.core.config import load_config
from octseg_torch.data import dicom
from octseg_torch.data.synth import make_synth_fold
from octseg_torch.infer.predict import main
from octseg_torch.train.checkpoint import initialize_model_dir
from octseg_torch.train.train import main as train

tmp = sys.argv[1]
for seed, (name, classes) in enumerate((('LM', ['Lumen']),
                                        ('FC_LC', ['Lipid core', 'Fibrous cap']))):
    initialize_model_dir(os.path.join(tmp, 'models', name), classes, 'Unet',
                         'resnet18', input_size=32, seed=seed)
dcm = os.path.join(tmp, 'IMG007')
dicom.dcmwrite(dcm, np.random.default_rng(0).integers(0, 255, (3, 40, 40), dtype=np.uint8))
cfg = load_config('predict', [f'data_dir={dcm}', f'models_dir={tmp}/models',
                              f'save_dir={tmp}/out', 'output_size=[24,32]',
                              "classes=[Lumen,'Fibrous cap']", 'device=cpu', 'block_size=2'])
result = main(cfg)
# the image-directory path over a PNG and a JPEG (the C++ entropy decoder)
import shutil
from octseg_torch.data.image import write_png
os.makedirs(f'{tmp}/images')
write_png(f'{tmp}/images/a.png', np.random.default_rng(1).integers(0, 255, (30, 20, 3), np.uint8))
shutil.copy(os.path.join(sys.argv[2], '444.jpg'), f'{tmp}/images/b.jpg')
images = main(load_config('predict', [f'data_dir={tmp}/images', f'models_dir={tmp}/models',
                                      f'save_dir={tmp}/out_images', 'output_size=[24,32]',
                                      "classes=[Lumen,'Fibrous cap']", 'device=cpu', 'bf16=true']))
make_synth_fold(f'{tmp}/fold', n_train=4, n_test=2, size=40, seed=1)
summary = train(overrides=[f'data_dir={tmp}/fold', f'save_dir={tmp}/models', 'device=cpu',
                           'architecture=Unet', 'encoder=resnet18', 'input_size=32',
                           'batch_size=2', 'epochs=1', 'classes=[Lumen]'])
# the zoo's dilated encoders and the tuner's numpy GP
import torch
from octseg_torch.models import create_model
from octseg_torch.tune.search import BayesianSearch, SearchSpace
with torch.no_grad():
    zoo = create_model('DeepLabV3Plus', 'resnet18').eval()(torch.zeros(1, 3, 32, 32))
space = SearchSpace({'architecture': ['FPN', 'PAN'], 'lr': [1e-3, 1e-4], 'input_size': [64]})
search = BayesianSearch(space, seed=0, n_random=3)
for value in (0.1, 0.5, 0.3):
    search.observe(search.suggest(), value)
gp_point = search.suggest()
banned = %r
loaded = sorted(m for m in sys.modules if m.split('.')[0] in banned)
print(json.dumps({'frames': result['frames'], 'outputs': sorted(os.listdir(f'{tmp}/out')),
                  'images': images['frames'],
                  'image_outputs': sorted(os.listdir(f'{tmp}/out_images')),
                  'train_steps': summary['train_steps'],
                  'model_files': sorted(os.listdir(summary['model_dir'])),
                  'zoo_shape': list(zoo.shape), 'gp_point': gp_point,
                  'loaded': loaded}))
''' % (BANNED,)


def test_cpu_predict_path_loads_no_banned_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ('PYTHONPATH',)}
    env['PYTHONPATH'] = REPO
    fixture = os.path.join(REPO, 'tests', 'torch_fixtures', 'jpeg')
    proc = subprocess.run([sys.executable, '-c', SCRIPT, str(tmp_path), fixture],
                          cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['loaded'] == []
    assert result['frames'] == 3
    assert len(result['outputs']) == 6 and 'IMG007_3_overlay.png' in result['outputs']
    assert result['images'] == 2 and result['image_outputs'] == [
        'a_mask.png', 'a_overlay.png', 'b_mask.png', 'b_overlay.png']
    assert result['train_steps'] == 2
    assert {'metrics.csv', 'weights.ckpt', 'resume.ckpt', 'config.json'} <= set(
        result['model_files'])
    assert result['zoo_shape'] == [1, 1, 32, 32]
    assert result['gp_point']['architecture'] in ('FPN', 'PAN')


def _python_files():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _dirs, names in os.walk(os.path.join(REPO, 'octseg_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


@pytest.mark.parametrize('path', _python_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_banned_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in BANNED, f'{path}:{node.lineno} imports {name}'
