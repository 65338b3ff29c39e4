"""octseg_torch's sweep aggregator against octseg's (pandas 3), on the CPU.

CSV mode: tuner results written here, with an empty cell in an int column
(pandas upcasts it to float and writes ``3.0``), NaN metrics, failed trials
whose metric beats every ``ok`` one, ties inside a group (the first row
wins) and across groups (the sort keeps row order), a bool column, a string
column, and classes whose columns differ (one has an extra column, one
lacks ``duration_s``), in the per-class and the flat layout:
configs_all.csv and configs_best.csv byte-equal to octseg's.

xlsx mode: W&B-like exports (two workbooks and one csv) with a blank index
header, metric columns to drop, a column only one export has, an empty
cell and tied DSCs: configs_all.xlsx and configs_best.xlsx record-equal to
octseg's, read back with either package's reader.
"""

import csv
import os

import pytest

from octseg.core.config import Config as JaxConfig
from octseg.data import xlsxio as jax_xlsxio
from octseg.tune import get_configs as jax_get_configs
from octseg_torch.core.config import Config
from octseg_torch.data import xlsxio
from octseg_torch.tune import get_configs

FIELDS = ['trial', 'architecture', 'encoder', 'optimizer', 'lr', 'input_size', 'val_f1',
          'val_loss', 'epochs_done', 'duration_s', 'status']


def _write_csv(path, fields, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(fields)
        writer.writerows(rows)


def _tuner_results(root, flat):
    lumen = [
        [0, 'Unet', 'resnet18', 'Adam', 0.0001, 512, 0.71, 0.3, 2, 10.5, 'ok'],
        [1, 'Unet', 'resnet34', 'RMSprop', 0.0003, 640, 0.93, 0.1, 3, 12.25, 'failed'],
        [2, 'FPN', 'efficientnet-b0', 'Adam', 1e-05, 768, 0.71, '', '', 8.0, 'ok'],
        [3, 'Unet', 'timm-regnetx_002', 'SGD', 0.001, 512, 0.82, 0.2, 1, 3.5, 'ok'],
        [4, 'Unet', 'resnet50', 'Adam', 0.0001, 896, 0.82, 0.25, 2, 9.0, 'ok'],
        [5, 'PSPNet', 'resnet101', 'Adam', 0.0003, 512, '', '', 0, 1.0, 'failed'],
        [6, 'PSPNet', 'resnet101', 'Adam', 0.0003, 512, 0.5, 0.6, 2, 4.75, 'ok'],
    ]
    if flat:
        _write_csv(os.path.join(root, 'tuning_results.csv'), FIELDS, lumen)
        return
    _write_csv(os.path.join(root, 'Lumen', 'tuning_results.csv'), FIELDS, lumen)
    fields = [f for f in FIELDS if f != 'duration_s'] + ['note', 'remat']
    cap = [
        [0, 'LinkNet', 'efficientnet-b7', 'Adam', 0.0001, 896, 0.64, 0.4, 2, 'ok', 'a, b', True],
        [1, 'LinkNet', 'resnet18', 'Adam', 0.0001, 896, 0.64, 0.4, 2, 'ok', '', False],
        [2, 'MAnet', 'timm-regnety_120', 'RMSprop', 0.001, 512, 0.7, 0.35, 2, 'ok', 'x', True],
    ]
    _write_csv(os.path.join(root, 'Fibrous cap', 'tuning_results.csv'), fields, cap)
    core = [
        [0, 'DeepLabV3', 'resnet101', 'Adam', 0.0003, 512, 0.88, 0.15, 2, 20.0, 'ok'],
        [1, 'DeepLabV3Plus', 'efficientnet-b5', 'Adam', 0.0003, 896, 0.88, 0.12, 2, 30.0, 'ok'],
        [2, 'DeepLabV3', 'resnet50', 'SGD', 0.0001, 512, 0.9, 0.1, 2, 15.0, 'failed'],
    ]
    _write_csv(os.path.join(root, 'Lipid core', 'tuning_results.csv'), FIELDS, core)


@pytest.mark.parametrize('flat', [False, True], ids=['per-class', 'flat'])
def test_csv_mode_byte_equal_to_octsegs(tmp_path, flat):
    tuning = str(tmp_path / 'tuning')
    _tuner_results(tuning, flat)
    jax_get_configs.main(JaxConfig(tuning_dir=tuning, save_dir=str(tmp_path / 'jax'),
                                   metric='val_f1', tuning_file_paths=[]))
    get_configs.main(Config(tuning_dir=tuning, save_dir=str(tmp_path / 'port'),
                            metric='val_f1', tuning_file_paths=[]))
    for name in ('configs_all.csv', 'configs_best.csv'):
        with open(tmp_path / 'jax' / name, 'rb') as f, open(tmp_path / 'port' / name, 'rb') as g:
            want, got = f.read(), g.read()
        assert got == want, (name, got.decode(), want.decode())
    with open(tmp_path / 'port' / 'configs_best.csv', newline='') as f:
        best = list(csv.DictReader(f))
    assert all(r['status'] == 'ok' for r in best)
    assert b',2.0,' in want   # epochs_done: an int column upcast by an empty cell


def test_all_na_metric_in_a_group_raises_as_octsegs(tmp_path):
    tuning = str(tmp_path / 'tuning')
    _write_csv(os.path.join(tuning, 'tuning_results.csv'), FIELDS,
               [[0, 'Unet', 'resnet18', 'Adam', 0.001, 512, '', 0.3, 1, 1.0, 'ok']])
    for main, config in ((jax_get_configs.main, JaxConfig), (get_configs.main, Config)):
        with pytest.raises(ValueError):
            main(config(tuning_dir=tuning, save_dir=str(tmp_path / 'out'), metric='val_f1',
                        tuning_file_paths=[]))


def _exports(root):
    header = [None, 'Name', 'State', 'Runtime', 'classes', 'architecture', 'encoder',
              'input_size', 'optimizer', 'lr', 'best_dice', 'best_iou', 'best_precision',
              'best_recall', 'best_dice_epoch', 'train/f1', 'test/loss',
              'best_iou_epoch']
    rows = [
        [0, 'run-a', 'finished', 3600, 'Lumen', 'Unet', 'resnet18', 512, 'Adam', 0.0001,
         0.91, 0.84, 0.9, 0.92, 40, 0.95, 0.1, 38],
        [1, 'run-b', 'finished', 3550.5, 'Lumen', 'Unet', 'resnet50', 512, 'Adam', 0.0003,
         0.91, 0.85, 0.88, 0.93, 41, 0.96, 0.09, 39],
        [2, 'run-c', 'crashed', 120, 'Lumen', 'FPN', 'efficientnet-b0', 768, 'RMSprop',
         0.001, None, None, None, None, None, 0.2, 0.8, None],
        [3, 'run-d', 'finished', 4000, 'Lumen', 'FPN', 'efficientnet-b7', 896, 'Adam',
         0.0001, 0.87, 0.8, 0.85, 0.9, 50, 0.9, 0.12, 45],
    ]
    first = os.path.join(root, 'lumen.xlsx')
    jax_xlsxio.write_xlsx(first, [header + ['extra']] + [r + ['e'] for r in rows])
    rows2 = [[0, 'run-e', 'finished', 2000, 'Fibrous cap', 'LinkNet', 'efficientnet-b7', 896,
              'Adam', 0.0001, 0.77, 0.7, 0.75, 0.8, 30, 0.8, 0.3, 28],
             [1, 'run-f', 'finished', 2100, 'Fibrous cap', 'LinkNet', 'resnet18', 640,
              'SGD', 0.01, 0.79, 0.71, 0.7, 0.82, 33, 0.85, 0.25, 30]]
    second = os.path.join(root, 'fibrous_cap.xlsx')
    # the same columns in another order
    order = [0, 2, 1] + list(range(3, len(header)))
    jax_xlsxio.write_xlsx(second, [[header[i] for i in order]] +
                          [[r[i] for i in order] for r in rows2])
    third = os.path.join(root, 'vasa_vasorum.csv')
    _write_csv(third, [''] + header[1:],
               [[0, 'run-g', 'finished', 900, 'Vasa vasorum', 'Unet', 'timm-regnetx_064', 896,
                 'Adam', 0.0003, 0.99, 0.98, 0.99, 0.99, 12, 1.0, 0.01, 11]])
    return [first, second, third]


def test_xlsx_mode_record_equal_to_octsegs(tmp_path):
    paths = _exports(str(tmp_path))
    jax_get_configs.main(JaxConfig(tuning_file_paths=paths, save_dir=str(tmp_path / 'jax')))
    get_configs.main(Config(tuning_file_paths=paths, save_dir=str(tmp_path / 'port')))
    for name, n_rows in (('configs_all.xlsx', 7), ('configs_best.xlsx', 4)):
        for read in (xlsxio.read_xlsx_records, jax_xlsxio.read_xlsx_records):
            want = read(str(tmp_path / 'jax' / name))
            got = read(str(tmp_path / 'port' / name))
            assert got == want and len(got) == n_rows, name
            assert list(got[0]) == jax_get_configs._COLUMN_ORDER
    best = xlsxio.read_xlsx_records(str(tmp_path / 'port' / 'configs_best.xlsx'))
    assert [r['Name'] for r in best if r['Architecture'] == 'Unet' and r['Class'] == 'Lumen'] \
        == ['run-a']   # tied DSC: the first row
