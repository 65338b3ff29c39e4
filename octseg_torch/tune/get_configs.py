"""Sweep-result aggregator: per-class tuning results -> best configs (the
port of octseg/tune/get_configs.py), without pandas.

- CSV mode (``tuning_dir``): ``<tuning_dir>/<class>/tuning_results.csv``
  (or one flat ``tuning_results.csv``, class ``all``) merged into
  ``configs_all.csv``, and the best ``ok`` row per (class, architecture) by
  ``metric`` into ``configs_best.csv``. The files are byte-equal to what
  octseg writes through pandas, whose behaviours ``Table`` keeps: read_csv's
  type inference (ints, floats, bools, strings; its NA strings and empty
  cells read as NaN; an int column with a NaN becomes float, written
  ``3.0``; a blank header cell named ``Unnamed: i``), concat's column
  union in order of appearance with NaN in the gaps, groupby's sorted keys
  (rows with a missing key dropped), idxmax's first maximum skipping NaN, a
  stable sort by class and then metric descending, and floats written as
  ``repr``.
- xlsx mode (``tuning_file_paths``): the reference's W&B exports (xlsx or
  csv) reduced to their shared columns in the first file's order, the
  metric columns dropped, renamed and reordered as octseg does, a 1-based
  ID, written as ``configs_all.xlsx``; the best DSC row per (Class,
  Architecture) as ``configs_best.xlsx``.

Config: configs/get_configs.yaml.
Usage: python -m octseg_torch.tune.get_configs [key=value ...]
"""

from __future__ import annotations

import logging
import os
from glob import glob
from pathlib import Path
from typing import Dict, List, Sequence

from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.table import NAN, Table, _is_na
from octseg_torch.data.xlsxio import read_xlsx_records, write_xlsx_records

log = logging.getLogger(__name__)

# columns the reference drops from the combined export
_DROP_COLUMNS = [
    'train/f1', 'train/precision', 'train/recall', 'train/iou', 'train/dice',
    'train/loss', 'test/f1', 'test/precision', 'test/recall', 'test/iou',
    'test/dice', 'test/loss', 'best_precision_epoch', 'best_recall_epoch',
    'best_iou_epoch',
]
_RENAME = {
    'Unnamed: 0': 'ID',
    'classes': 'Class',
    'architecture': 'Architecture',
    'encoder': 'Encoder',
    'input_size': 'Input size',
    'optimizer': 'Optimizer',
    'lr': 'LR',
    'best_dice': 'DSC',
    'best_iou': 'IoU',
    'best_precision': 'Precision',
    'best_recall': 'Recall',
    'best_dice_epoch': 'Epoch',
}
_COLUMN_ORDER = [
    'ID', 'Name', 'State', 'Runtime', 'Class', 'Architecture', 'Encoder',
    'Input size', 'Optimizer', 'LR', 'DSC', 'IoU', 'Precision', 'Recall',
    'Epoch',
]

def _group_best(rows: List[dict], keys: Sequence[str], metric: str) -> List[dict]:
    """The first row of the largest ``metric`` (NaN skipped) per group of
    ``keys``, groups in sorted key order and rows with a missing key
    dropped, as pandas' ``groupby(keys)[metric].idxmax()``."""
    groups: Dict[tuple, List[dict]] = {}
    for r in rows:
        key = tuple(r[k] for k in keys)
        if not any(_is_na(v) for v in key):
            groups.setdefault(key, []).append(r)
    best = []
    for key in sorted(groups):
        candidates = [r for r in groups[key] if not _is_na(r[metric])]
        if not candidates:
            raise ValueError(f'{key}: {metric} holds only NA values')
        top = max(r[metric] for r in candidates)
        best.append(next(r for r in candidates if r[metric] == top))
    return best


def load_class_results(tuning_dir: str) -> Table:
    """<tuning_dir>/<class_name>/tuning_results.csv files, the directory
    name as the class label; else one flat tuning_results.csv as 'all'."""
    tables = []
    for csv_path in sorted(glob(os.path.join(tuning_dir, '*', 'tuning_results.csv'))):
        t = Table.read_csv(csv_path)
        t.add_column('class', Path(csv_path).parent.name)
        tables.append(t)
    flat = os.path.join(tuning_dir, 'tuning_results.csv')
    if not tables and os.path.exists(flat):
        t = Table.read_csv(flat)
        t.add_column('class', 'all')
        tables.append(t)
    if not tables:
        raise FileNotFoundError(f'No tuning_results.csv under {tuning_dir}')
    return Table.concat(tables)


def best_configs(table: Table, metric: str = 'val_f1') -> Table:
    """The best ``ok`` row per (class, architecture) by ``metric``, sorted by
    class and then metric, largest first."""
    rows = table.rows()
    if 'status' in table.columns:
        rows = [r for r in rows if r['status'] == 'ok']
    best = _group_best(rows, ('class', 'architecture'), metric)
    # stable sorts: metric descending, then class ascending
    best.sort(key=lambda r: -r[metric])
    best.sort(key=lambda r: r['class'])
    return Table.from_rows(table.columns, best)


def _read_export(path: str) -> List[dict]:
    if path.endswith('.csv'):
        return Table.read_csv(path).rows()
    return read_xlsx_records(path)


def combine_export_files(paths: List[str]) -> Table:
    """The reference's combine_excel_files: shared columns, concatenated,
    metric columns dropped, renamed, reordered, 1-based ID."""
    exports = [_read_export(p) for p in paths]
    columns_of = []
    for records in exports:
        cols: List[str] = []
        for r in records:
            cols += [c for c in r if c not in cols]
        columns_of.append(cols)
    common = set(columns_of[0]).intersection(*columns_of[1:])
    columns = [c for c in columns_of[0] if c in common]
    rows = [{c: r.get(c) for c in columns} for records in exports for r in records]
    rows = [{_RENAME.get(c, c): v for c, v in r.items() if c not in _DROP_COLUMNS}
            for r in rows]
    missing = [c for c in _COLUMN_ORDER if rows and c not in rows[0]]
    if missing:
        raise KeyError(f'{missing} not in the exports\' shared columns')
    for r in rows:
        r['ID'] = r['ID'] + 1 if not _is_na(r['ID']) else NAN
    return Table.from_rows(_COLUMN_ORDER, rows)


def best_architectures(table: Table) -> Table:
    """The max-DSC row per (Class, Architecture), groups in sorted key order."""
    return Table.from_rows(table.columns, _group_best(table.rows(), ('Class', 'Architecture'),
                                                      'DSC'))


def _to_xlsx(table: Table, path: str) -> None:
    write_xlsx_records(path, table.rows(), columns=list(table.columns))


@entry_point('get_configs')
def main(cfg: Config) -> None:
    os.makedirs(cfg.save_dir, exist_ok=True)
    paths = list(cfg.get('tuning_file_paths', []) or [])
    if paths:  # the reference's xlsx exports
        table = combine_export_files(paths)
        _to_xlsx(table, os.path.join(cfg.save_dir, 'configs_all.xlsx'))
        best = best_architectures(table)
        _to_xlsx(best, os.path.join(cfg.save_dir, 'configs_best.xlsx'))
    else:  # the tuner's CSVs
        table = load_class_results(cfg.tuning_dir)
        table.to_csv(os.path.join(cfg.save_dir, 'configs_all.csv'))
        best = best_configs(table, metric=cfg.get('metric', 'val_f1'))
        best.to_csv(os.path.join(cfg.save_dir, 'configs_best.csv'))
    log.info('Merged %d trials; %d best configs', len(table), len(best))
    log.info('Complete')


if __name__ == '__main__':
    main()
