"""octseg_torch's runtime imports torch, numpy and the standard library only.

The machine with the card has no jax, flax, optax, cv2, PIL, yaml or
msgpack, and the port must not lean on the JAX package: a clean interpreter
runs the port's CPU predict path on a tiny pullback and on an image
directory (a PNG and a JPEG, bf16), a CPU training epoch (augmentation
on, through the C++ loader) on a tiny synthetic fold, a DeepLabV3Plus forward
(a dilated encoder), a GP-EI suggestion of the tuner after three
observations, one NativeLoader batch, one GradCAM map and the
reference-checkpoint import of a Lightning-style state dict, and must not
have loaded any of them (nor sklearn, which octseg's tuner fits its GP
with); a second one runs the analyze app (demo and inference analysis,
frame contours, the figures, the HTTP app) and the data-prep chain (every
stage's entry point, the pipeline runner and its stage file) on tiny inputs, and
must not have loaded them, nor pandas or matplotlib; an AST scan checks
every import statement of the package, of chip_smoke.py and of the
stream writer it imports (tests/jpeg_streams.py).
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
          'scipy', 'sklearn', 'pandas', 'matplotlib')

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
# the C++ training loader and CAM explainability
from octseg_torch.explain import CAMProcessor
from octseg_torch.train.data import OCTDataset
from octseg_torch.train.native_loader import NativeLoader
native = next(iter(NativeLoader(OCTDataset(f'{tmp}/fold/train', ['Lumen'], 32), 2,
                                num_workers=2)))
x = np.random.default_rng(2).normal(0, 1, (32, 32, 3)).astype(np.float32)
cam = CAMProcessor(create_model('Unet', 'resnet18').eval()).extract_activation_map(
    x, 0, np.ones((32, 32), np.float32))
# the reference-checkpoint import of a Lightning-style SMP state dict
from octseg_torch.models.convert_torch import convert_reference_model_dir
os.makedirs(f'{tmp}/reference')
torch.save({'state_dict': {f'model.{k}': v for k, v in
                           create_model('Unet', 'resnet18').state_dict().items()}, 'epoch': 1},
           f'{tmp}/reference/weights.ckpt')
shutil.copy(f'{tmp}/models/LM/config.json', f'{tmp}/reference')
converted = sorted(os.listdir(convert_reference_model_dir(f'{tmp}/reference',
                                                          f'{tmp}/converted')))
banned = %r
loaded = sorted(m for m in sys.modules if m.split('.')[0] in banned)
print(json.dumps({'frames': result['frames'], 'outputs': sorted(os.listdir(f'{tmp}/out')),
                  'converted': converted,
                  'images': images['frames'],
                  'image_outputs': sorted(os.listdir(f'{tmp}/out_images')),
                  'train_steps': summary['train_steps'],
                  'model_files': sorted(os.listdir(summary['model_dir'])),
                  'zoo_shape': list(zoo.shape), 'gp_point': gp_point,
                  'loader': summary['loader'],
                  'native_shapes': [list(a.shape) for a in native],
                  'cam': [list(cam.shape), float(cam.min()), float(cam.max())],
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
    assert result['converted'] == ['config.json', 'weights.ckpt']
    assert result['zoo_shape'] == [1, 1, 32, 32]
    assert result['gp_point']['architecture'] in ('FPN', 'PAN')
    assert result['loader'] == 'native'
    assert result['native_shapes'] == [[2, 32, 32, 3], [2, 32, 32, 1]]
    shape, low, high = result['cam']
    assert shape == [32, 32] and 0 <= low <= high <= 1


APP_SCRIPT = r"""
import json, os, sys, urllib.request
import numpy as np
tmp = sys.argv[1]
os.chdir(tmp)
from octseg_torch.analyze import analysis, app, figures
from octseg_torch.core.config import Config
from octseg_torch.core.pipeline import Pipeline
from octseg_torch.data import dicom, mask_processor
from octseg_torch.data.tiffio import write_tiff
from octseg_torch.data.image import write_png
from octseg_torch.data.utils import convert_numpy_to_base64
from octseg_torch.train.checkpoint import initialize_model_dir
rng = np.random.default_rng(0)
for seed, (name, classes) in enumerate((('LM', ['Lumen']), ('FC_LC', ['Lipid core', 'Fibrous cap']),
                                        ('VV', ['Vasa vasorum']))):
    initialize_model_dir(os.path.join(tmp, 'models', name), classes, 'Unet', 'resnet18',
                         input_size=32, seed=seed)
os.makedirs('demo/img'); os.makedirs('demo/mask')
for i in range(3):
    write_png(f'demo/img/frame_{i + 1:03d}.png', rng.integers(0, 255, (40, 40, 3), np.uint8))
    m = np.zeros((40, 40, 4), np.uint8)
    m[5 + i:20, 8:30, i % 4] = 255
    write_tiff(f'demo/mask/frame_{i + 1:03d}.tiff', m)
demo = analysis.get_analysis(None, 'demo', demo_dir='demo')
contours = analysis.frame_contours(demo, 0)
svgs = [figures.get_object_map(demo), figures.get_plot_area(['Lumen'], demo)]
dicom.dcmwrite('IMG001', rng.integers(0, 255, (2, 40, 40), dtype=np.uint8))
server = app.serve(Config(host='127.0.0.1', port=0, demo_dir='demo', models_dir='models',
                          temp_dir='temp', device='cpu'), block=False)
url = 'http://%s:%d' % server.server_address
req = urllib.request.Request(url + '/analyze?mode=inference', data=open('IMG001', 'rb').read(),
                             method='POST')
info = json.loads(urllib.request.urlopen(req).read())
frame = urllib.request.urlopen(url + '/frame.png?num=1').read()
server.shutdown()
# the data-prep chain in process (sys.modules sees every stage), then the
# runner over the port's stage file's order and a one-stage file
from octseg_torch.data import (convert_dicoms, convert_int_to_cv, convert_sly_to_int,
                               extract_metadata, stack_images)
for s in range(1, 6):
    dicom.dcmwrite(f'data/dcm/{s:03d}/IMG{s:03d}', rng.integers(0, 255, (1, 24, 24, 3), np.uint8))
extract_metadata.main(Config(data_dir='data/dcm', save_dir='data'))
for gray in (False, True):
    convert_dicoms.main(Config(data_dir='data/dcm', save_dir=f'data/sly_input_{gray}',
                               output_size=[20, 20], to_gray=gray, output_type='image', fps=5))
stack_images.main(Config(data_dir_1='data/sly_input_False', data_dir_2='data/sly_input_True',
                         save_dir='data/sly_input', output_size=[20, 20], output_type='image',
                         fps=5))
for s in range(1, 6):
    ds = f'data/sly_output/{s:03d}'
    os.makedirs(f'{ds}/ann'); os.makedirs(f'{ds}/frames/{s:03d}_{s}.mp4')
    os.link(f'data/sly_input/{s:03d}/{s}/{s:03d}_{s}_001.png', f'{ds}/frames/{s:03d}_{s}.mp4/001.png')
    m = np.zeros((8, 8), bool); m[1:7, 2:6] = True
    fig = {'objectKey': 'k', 'geometryType': 'bitmap',
           'geometry': {'bitmap': {'origin': [4, 4], 'data': convert_numpy_to_base64(m)}}}
    poly = {'objectKey': 'p', 'geometryType': 'polygon',
            'geometry': {'points': {'exterior': [[2, 2], [15, 4], [6, 16]], 'interior': []}}}
    json.dump({'framesCount': 1, 'size': {'height': 20, 'width': 40},
               'objects': [{'key': 'k', 'classTitle': 'Lumen'}, {'key': 'p', 'classTitle': 'Lipid core'}],
               'frames': [{'index': 0, 'figures': [fig, poly]}]}, open(f'{ds}/ann/{s:03d}_{s}.mp4.json', 'w'))
convert_sly_to_int.main(Config(data_dir='data/sly_output', save_dir='data/interim',
                               crop=[[0, 0], [20, 20]]))
convert_int_to_cv.main(Config(data_dir='data/interim', save_dir='data/cv', save_color_mask=True,
                              smooth_mask=True, num_folds=5, seed=11, split_column='study',
                              crop=[[2, 0], [18, 16]],
                              classes=['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum']))
first = Pipeline(lock_file='stages.lock')._topo_order()
open('one.yaml', 'w').write('stages:\n  a:\n    cmd: echo hi > a.txt\n    deps: []\n    outs:\n      - a.txt\n')
rest = Pipeline('one.yaml').repro() + Pipeline('one.yaml').repro()
banned = BANNED_NAMES
loaded = sorted(m for m in sys.modules if m.split('.')[0] in banned)
print(json.dumps({'demo_frames': len(demo['images']), 'contours': len(contours['objects']),
                  'svgs': [s[:4].decode() for s in svgs], 'inference_frames': info['n_frames'],
                  'frame_png': frame[:4].decode('latin-1'), 'first': first, 'rest': rest,
                  'folds': sorted(os.listdir('data/cv')), 'loaded': loaded}))
""".replace('BANNED_NAMES', repr(BANNED))


def test_app_and_data_prep_load_no_banned_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ('PYTHONPATH',)}
    env['PYTHONPATH'] = REPO
    proc = subprocess.run([sys.executable, '-c', APP_SCRIPT, str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['loaded'] == []
    assert result['demo_frames'] == 3 and result['contours'] == 1
    assert result['svgs'] == ['<svg', '<svg'] and result['frame_png'] == '\x89PNG'
    assert result['inference_frames'] == 2
    assert result['first'] == ['extract_metadata', 'convert_dicoms_rgb', 'convert_dicoms_gray',
                               'stack_images', 'convert_sly_to_int', 'convert_int_to_cv']
    assert result['rest'] == ['a']
    assert result['folds'] == ['fold_1', 'fold_2', 'fold_3', 'fold_4', 'fold_5', 'metadata.csv']


def _python_files():
    # chip_smoke.py writes its lossless streams with tests/jpeg_streams.py
    files = [os.path.join(REPO, 'chip_smoke.py'), os.path.join(REPO, 'tests', 'jpeg_streams.py')]
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
