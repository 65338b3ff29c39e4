"""octseg_torch's data-prep chain against octseg's, stage by stage.

One synthetic set, made from a seed with numpy, goes through both chains:
DICOMs (RGB and grayscale) -> dcm_metadata.csv -> RGB and gray PNG slices
-> stacked PNGs -> a Supervisely project over the stacked frames (polygons,
some self-crossing or crossing the crop, and bitmaps) -> interim frames and
metadata.csv -> five CV folds with refined masks, colour masks and the
elliptical crop. Held: the metadata CSV byte-equal; every PNG and TIFF
decoded equal; the interim metadata.csv equal with the base64 masks
compared decoded; the folds' files and metadata.csv equal, and the port's
KFold equal to sklearn's; ``refine_shape`` and ``keep_largest_regions``
equal octseg's at k = 1-7. The port's stage file has the root
pipeline.yaml's DAG, and its runner orders and caches as octseg's does.
Tolerance: none anywhere.
"""

import csv
import json
import os

import cv2
import numpy as np
import pytest
import yaml

import octseg
from octseg.core.config import Config as JaxConfig
from octseg.data import convert_dicoms as jax_convert_dicoms
from octseg.data import convert_int_to_cv as jax_int_to_cv
from octseg.data import convert_sly_to_int as jax_sly_to_int
from octseg.data import extract_metadata as jax_extract_metadata
from octseg.data import mask_processor as jax_mask_processor
from octseg.data import stack_images as jax_stack_images
from octseg.data.tiffio import read_tiff
from octseg_torch.core.config import Config
from octseg_torch.core.pipeline import STAGE_FILE, Pipeline
from octseg_torch.data import convert_dicoms, convert_int_to_cv, convert_sly_to_int
from octseg_torch.data import extract_metadata, mask_processor, stack_images
from octseg_torch.data.utils import convert_base64_to_numpy, convert_numpy_to_base64
from tests.torch_threads import torch_threads_share  # noqa: F401

SIZE = 96          # DICOM frame side
OUT = 80           # converted frame side (a downscale through resize_keep_aspect)
N_STUDIES = 5      # KFold(5) needs five studies
N_FRAMES = 3
CLASSES = ['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum']


def _figures(rng, study: int, frame: int, keys: list, width: int):
    """The figures of one frame: a polygon and a bitmap, a self-crossing or
    crop-crossing polygon on some frames, none on the last frame of study 2."""
    if study == 2 and frame == N_FRAMES - 1:
        return []
    figs = []
    cx, cy = 20 + 6 * frame + study, 30 + 4 * study
    n = 9
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(6, 16, n)
    poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).astype(int).tolist()
    if frame == 1:
        poly = [[cx - 10, cy - 10], [cx + 12, cy + 9], [cx + 12, cy - 10], [cx - 10, cy + 9]]
    if study == 4 and frame == 0:   # crosses the crop's right edge
        poly = [[66, 10], [95, 20], [70, 40]]
    keys.append((f'p{study}{frame}', CLASSES[(study + frame) % 4]))
    figs.append({'objectKey': keys[-1][0], 'geometryType': 'polygon',
                 'geometry': {'points': {'exterior': poly, 'interior': []}}})
    m = rng.random((18, 22)) > 0.35
    m[2:16, 3:19] = True
    keys.append((f'b{study}{frame}', CLASSES[(study + frame + 1) % 4]))
    figs.append({'objectKey': keys[-1][0], 'geometryType': 'bitmap',
                 'geometry': {'bitmap': {'origin': [40 + frame, 35 + study],
                                         'data': convert_numpy_to_base64(m)}}})
    if study == 1 and frame == 0:   # wholly outside the crop: skipped
        keys.append(('out', 'Lumen'))
        figs.append({'objectKey': 'out', 'geometryType': 'polygon',
                     'geometry': {'points': {'exterior': [[width - 5, 2], [width - 2, 9],
                                                          [width - 8, 9]], 'interior': []}}})
    return figs


def _sly_project(root, stacked_dir, rng):
    """A Supervisely project over the stacked frames (frames/ dirs)."""
    sly = root / 'sly_output'
    for s in range(1, N_STUDIES + 1):
        study = f'{s:03d}'
        ds_dir = sly / study
        (ds_dir / 'ann').mkdir(parents=True)
        frames_dir = ds_dir / 'frames' / f'{study}_{s}.mp4'
        frames_dir.mkdir(parents=True)
        stacked = sorted((stacked_dir / study / str(s)).glob('*.png'))
        for i, p in enumerate(stacked, 1):
            (frames_dir / f'{i:03d}.png').write_bytes(p.read_bytes())
        h, w = cv2.imread(str(stacked[0])).shape[:2]
        keys, frames = [], []
        for fi in range(N_FRAMES):
            frames.append({'index': fi, 'figures': _figures(rng, s, fi, keys, w)})
        ann = {'framesCount': N_FRAMES, 'size': {'height': h, 'width': w},
               'objects': [{'key': k, 'classTitle': c} for k, c in keys], 'frames': frames}
        (ds_dir / 'ann' / f'{study}_{s}.mp4.json').write_text(json.dumps(ann))
    return sly


def _run_chain(pkg, root, dcm, sly_factory, cfg_cls):
    extract, dicoms, stack, sly_to_int, int_to_cv = pkg
    extract.main(cfg_cls(data_dir=str(dcm), save_dir=str(root)))
    for gray, name in ((False, 'rgb'), (True, 'gray')):
        dicoms.main(cfg_cls(data_dir=str(dcm), save_dir=str(root / f'sly_input_{name}'),
                            output_size=[OUT, OUT], to_gray=gray, output_type='image', fps=5,
                            include_dirs=[], exclude_dirs=[]))
    stack.main(cfg_cls(data_dir_1=str(root / 'sly_input_rgb'),
                       data_dir_2=str(root / 'sly_input_gray'), save_dir=str(root / 'sly_input'),
                       output_size=[OUT, OUT], output_type='image', fps=5, include_dirs=[],
                       exclude_dirs=[]))
    sly = sly_factory(root / 'sly_input')
    sly_to_int.main(cfg_cls(data_dir=str(sly), save_dir=str(root / 'interim'),
                            crop=[[0, 0], [OUT, OUT]]))
    int_to_cv.main(cfg_cls(data_dir=str(root / 'interim'), save_dir=str(root / 'cv'),
                           save_color_mask=True, smooth_mask=True, num_folds=5, seed=11,
                           split_column='study', crop=[[8, 0], [72, 64]], classes=CLASSES))


@pytest.fixture(scope='module')
def chains(tmp_path_factory):
    from octseg.data import dicom

    rng = np.random.default_rng(12)
    root = tmp_path_factory.mktemp('dataprep')
    dcm = root / 'dcm'
    for s in range(1, N_STUDIES + 1):
        shape = (N_FRAMES, SIZE, SIZE) if s == 3 else (N_FRAMES, SIZE, SIZE, 3)
        frames = rng.integers(10, 230, shape, dtype=np.uint8)
        dicom.dcmwrite(str(dcm / f'{s:03d}' / f'IMG{s:03d}'), frames,
                       tags={'AcquisitionTime': ('091500.000000', '1425', '07')[s % 3],
                             'AcquisitionDate': '20230304', 'PatientName': f'P^{s}'})
    sly_root = root / 'shared'
    sly_root.mkdir()
    made = {}

    def sly_factory(stacked_dir):
        if 'sly' not in made:   # the project is built once, over octseg's stacked frames
            made['sly'] = _sly_project(sly_root, stacked_dir, np.random.default_rng(3))
        return made['sly']

    jax_root, port_root = root / 'jax', root / 'port'
    _run_chain((jax_extract_metadata, jax_convert_dicoms, jax_stack_images, jax_sly_to_int,
                jax_int_to_cv), jax_root, dcm, sly_factory, JaxConfig)
    cwd = os.getcwd()
    os.chdir(octseg.PROJECT_DIR)   # relative paths of the port resolve here, as octseg's do
    try:
        _run_chain((extract_metadata, convert_dicoms, stack_images, convert_sly_to_int,
                    convert_int_to_cv), port_root, dcm, sly_factory, Config)
    finally:
        os.chdir(cwd)
    return {'jax': jax_root, 'port': port_root}


def _files(root, sub):
    base = root / sub
    return sorted(str(p.relative_to(base)) for p in base.rglob('*') if p.is_file())


def test_metadata_csv_byte_equal(chains):
    assert (chains['port'] / 'dcm_metadata.csv').read_bytes() == \
        (chains['jax'] / 'dcm_metadata.csv').read_bytes()


@pytest.mark.parametrize('sub', ['sly_input_rgb', 'sly_input_gray', 'sly_input', 'interim/img'])
def test_pngs_decode_equal(chains, sub):
    names = _files(chains['jax'], sub)
    assert names and names == _files(chains['port'], sub)
    for n in names:
        a = cv2.imread(str(chains['jax'] / sub / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(chains['port'] / sub / n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(b, a, err_msg=n)


def _read_rows(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def test_interim_metadata_equal_with_masks_decoded(chains):
    jax_rows = _read_rows(chains['jax'] / 'interim' / 'metadata.csv')
    port_rows = _read_rows(chains['port'] / 'interim' / 'metadata.csv')
    # two figures a frame, one frame with none (one empty row), the figure
    # outside the crop skipped
    assert len(port_rows) == len(jax_rows) == N_STUDIES * N_FRAMES * 2 - 1
    assert sum(not r['class_name'] for r in jax_rows) == 1
    for a, b in zip(jax_rows, port_rows):
        ja, jb = a.pop('encoded_mask'), b.pop('encoded_mask')
        # img_path holds each chain's own interim dir, relative to the repository
        b['img_path'] = b['img_path'].replace('/port/interim/', '/jax/interim/')
        assert b == a
        if ja:
            np.testing.assert_array_equal(convert_base64_to_numpy(jb),
                                          convert_base64_to_numpy(ja))
        else:
            assert jb == ''


def test_folds_equal(chains):
    jax_cv, port_cv = chains['jax'] / 'cv', chains['port'] / 'cv'
    names = _files(chains['jax'], 'cv')
    assert names == _files(chains['port'], 'cv')
    assert {n.split('/')[0] for n in names} == {f'fold_{k}' for k in range(1, 6)} | {
        'metadata.csv'}
    for n in names:
        if n.endswith('.png'):
            np.testing.assert_array_equal(cv2.imread(str(port_cv / n)),
                                          cv2.imread(str(jax_cv / n)), err_msg=n)
        elif n.endswith('.tiff'):
            np.testing.assert_array_equal(read_tiff(str(port_cv / n)),
                                          read_tiff(str(jax_cv / n)), err_msg=n)
    masks = [read_tiff(str(jax_cv / n)) for n in names if '/mask/' in n]
    assert masks and all(m.shape == (64, 64, 4) for m in masks)
    assert sum(int(m.any()) for m in masks) >= len(masks) // 2
    # img_path holds each chain's own interim dir
    port_csv = (port_cv / 'metadata.csv').read_text().replace(
        str(chains['port'] / 'interim'), str(chains['jax'] / 'interim'))
    assert port_csv == (jax_cv / 'metadata.csv').read_text()


@pytest.mark.parametrize('n,folds,seed', [(5, 5, 11), (6, 5, 11), (13, 5, 0), (7, 3, 42),
                                          (20, 4, 2024)])
def test_kfold_equals_sklearn(n, folds, seed):
    from sklearn.model_selection import KFold

    want = list(KFold(n_splits=folds, shuffle=True, random_state=seed).split(np.arange(n)))
    got = convert_int_to_cv.kfold_indices(n, folds, seed)
    assert len(got) == len(want)
    for (gt, ge), (wt, we) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge, we)


def test_kfold_refuses_more_folds_than_studies():
    with pytest.raises(ValueError, match='n_splits=5'):
        convert_int_to_cv.kfold_indices(2, 5, 11)


def _object_masks(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:72, :90]
    m = np.zeros((72, 90), np.uint8)
    for _ in range(5):
        cy, cx, r = rng.integers(0, 72), rng.integers(0, 90), rng.integers(3, 16)
        m |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8)
    ring = ((yy - 36) ** 2 + (xx - 45) ** 2 < 400) & ((yy - 36) ** 2 + (xx - 45) ** 2 >= 100)
    m[ring] = 1
    m ^= (rng.random(m.shape) > 0.96).astype(np.uint8)
    return m


@pytest.mark.parametrize('k', range(1, 8))
def test_mask_refinement_equals_octseg(k):
    for seed in range(3):
        m = _object_masks(seed + 10 * k)
        refined = mask_processor.refine_shape(m, k)
        np.testing.assert_array_equal(refined, jax_mask_processor.refine_shape(m, k))
        np.testing.assert_array_equal(mask_processor.keep_largest_regions(refined),
                                      jax_mask_processor.keep_largest_regions(refined))


def test_keep_largest_regions_keeps_ties():
    m = np.zeros((30, 60), np.uint8)
    for x in (2, 14, 26, 38, 50):   # five equal squares
        m[5:11, x:x + 6] = 1
    m[20:24, 2:6] = 1
    got = mask_processor.keep_largest_regions(m)
    np.testing.assert_array_equal(got, jax_mask_processor.keep_largest_regions(m))
    assert got[5:11].sum() == 5 * 36 and got[20:24].sum() == 0


def test_stage_file_has_the_root_dag(tmp_path):
    root = yaml.safe_load(open(os.path.join(octseg.PROJECT_DIR, 'pipeline.yaml')))['stages']
    port = yaml.safe_load(open(STAGE_FILE))['stages']
    assert list(port) == list(root)
    for name, stage in root.items():
        assert port[name]['deps'] == stage['deps'] and port[name]['outs'] == stage['outs']
        want = stage['cmd'].replace('octseg.data.', 'octseg_torch.data.')
        if name == 'stack_images':
            want += ' output_type=image'
        assert port[name]['cmd'] == want
    lock = str(tmp_path / 'pipeline.lock')
    assert Pipeline(STAGE_FILE, lock_file=lock)._topo_order() == list(root)


def test_pipeline_runs_in_dep_order_and_caches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stages = {
        'b': {'cmd': 'cat a.txt a.txt > b.txt', 'deps': ['a.txt'], 'outs': ['b.txt']},
        'a': {'cmd': 'echo hi > a.txt', 'deps': [], 'outs': ['a.txt']},
        'c': {'cmd': 'cat b.txt > c.txt', 'deps': ['b.txt'], 'outs': ['c.txt']},
    }
    pfile = tmp_path / 'stages.yaml'
    pfile.write_text(yaml.safe_dump({'stages': stages}))
    ran = Pipeline(str(pfile)).repro()
    assert ran.index('a') < ran.index('b') < ran.index('c')
    assert (tmp_path / 'c.txt').read_text().strip() == 'hi\nhi'
    assert (tmp_path / 'pipeline.lock').exists()
    assert Pipeline(str(pfile)).repro() == []
    # a changed out re-runs only its producer, which restores it
    (tmp_path / 'a.txt').write_text('changed\n')
    assert Pipeline(str(pfile)).repro() == ['a']
    assert (tmp_path / 'a.txt').read_text().strip() == 'hi'
    # a changed command cascades through its dependents
    stages['a']['cmd'] = 'echo bye > a.txt'
    pfile.write_text(yaml.safe_dump({'stages': stages}))
    assert Pipeline(str(pfile)).repro() == ['a', 'b', 'c']
    assert (tmp_path / 'c.txt').read_text().strip() == 'bye\nbye'
    assert Pipeline(str(pfile)).repro(['b'], force=True) == ['a', 'b']


def test_video_output_raises(tmp_path):
    with pytest.raises(NotImplementedError, match='Video output and reading'):
        convert_dicoms.main(Config(data_dir=str(tmp_path), save_dir=str(tmp_path / 'o'),
                                   output_size=[8, 8], to_gray=False, output_type='video', fps=5))
    with pytest.raises(NotImplementedError, match='Video output and reading'):
        stack_images.main(Config(data_dir_1=str(tmp_path), data_dir_2=str(tmp_path),
                                 save_dir=str(tmp_path / 'o'), output_size=[8, 8],
                                 output_type='video', fps=5))
    ds = tmp_path / 'sly' / '001'
    (ds / 'ann').mkdir(parents=True)
    (ds / 'video').mkdir()
    (ds / 'ann' / '001_1.mp4.json').write_text(json.dumps(
        {'framesCount': 1, 'size': {'height': 8, 'width': 8}, 'objects': [], 'frames': []}))
    with pytest.raises(NotImplementedError, match='no video decoder'):
        convert_sly_to_int.main(Config(data_dir=str(tmp_path / 'sly'),
                                       save_dir=str(tmp_path / 'interim'), crop=[[0, 0], [8, 8]]))
