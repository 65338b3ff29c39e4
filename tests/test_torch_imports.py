"""octseg_torch's runtime imports torch, numpy and the standard library only.

The machine with the card has no jax, flax, cv2, PIL, yaml or msgpack, and
the port must not lean on the JAX package: a clean interpreter runs the
port's CPU predict path on a tiny pullback and must not have loaded any of
them; an AST scan checks every import statement of the package and of
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
BANNED = ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'yaml', 'msgpack', 'octseg', 'scipy')

SCRIPT = r'''
import json, os, sys
import numpy as np
from octseg_torch.core.config import load_config
from octseg_torch.data import dicom
from octseg_torch.infer.predict import main
from octseg_torch.train.checkpoint import initialize_model_dir

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
banned = %r
loaded = sorted(m for m in sys.modules if m.split('.')[0] in banned)
print(json.dumps({'frames': result['frames'], 'outputs': sorted(os.listdir(f'{tmp}/out')),
                  'loaded': loaded}))
''' % (BANNED,)


def test_cpu_predict_path_loads_no_banned_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ('PYTHONPATH',)}
    env['PYTHONPATH'] = REPO
    proc = subprocess.run([sys.executable, '-c', SCRIPT, str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['loaded'] == []
    assert result['frames'] == 3
    assert len(result['outputs']) == 6 and 'IMG007_3_overlay.png' in result['outputs']


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
