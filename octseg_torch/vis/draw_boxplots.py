"""Per-class best-epoch boxplots over the CV folds, and best_metrics.csv.

The port of octseg/vis/draw_boxplots.py, without pandas, matplotlib or
seaborn: the ``metrics.csv`` files under ``class_dirs`` are read with the
fold id from each path (``fold_<k>``; a path without one warns and is
fold 0), filtered to ``split``; per fold and class the row of the largest
``metric`` (its first occurrence, as pandas' ``idxmax``) is kept, in
octseg's order (folds, then classes, as they first appear), and written as
``best_metrics.csv`` byte for byte as octseg's ``to_csv``. Each class of
CLASS_ORDER that has rows gets a box with matplotlib's
``cbook.boxplot_stats(whis=1.5)`` (``analyze/figures.boxplot_stats``),
drawn without fliers, as octseg's seaborn call does. The figure is an SVG
with octseg's file stem.

Config: configs/draw_boxplots.yaml.
Usage: python -m octseg_torch.vis.draw_boxplots class_dirs=[<dir>,...] save_dir=<dir> \\
    [split=test] [metric=Dice]
"""

from __future__ import annotations

import logging
import math
import os
import re
from typing import List, Optional, Sequence

import octseg_torch
from octseg_torch.analyze.figures import _rgb, _Svg, boxplot_stats
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.table import Table
from octseg_torch.data.utils import get_file_list

log = logging.getLogger(__name__)

CLASS_ORDER = ['Lumen', 'Fibrous cap', 'Lipid core', 'Vasa vasorum']
# seaborn's 'muted' palette, its first four colours
COLORS = ((72, 120, 208), (238, 133, 74), (106, 204, 100), (214, 95, 95))


def get_fold_id(path: str) -> Optional[int]:
    match = re.search(r'fold_(\d+)', path)
    return int(match.group(1)) if match else None


def read_model_metrics(csv_paths: Sequence[str]) -> Table:
    """Every file's rows with a ``Fold`` column last."""
    tables = []
    for p in csv_paths:
        table = Table.read_csv(p)
        fold = get_fold_id(p)
        if fold is None:
            log.warning('%s: no fold_N in path, grouping under fold 0', p)
            fold = 0
        table.add_column('Fold', fold)
        tables.append(table)
    return Table.concat(tables)


def rows_where(table: Table, column: str, value) -> Table:
    return table.take([i for i, v in enumerate(table.column(column)) if v == value])


def get_best_epoch(table: Table, metric: str = 'Dice') -> Table:
    """Per fold and class, the row of the largest ``metric`` (NaN skipped,
    the first of equal maxima)."""
    best = []
    for fold in table.unique('Fold'):
        for cls in table.unique('Class'):
            rows = [i for i, (f, c) in enumerate(zip(table.column('Fold'), table.column('Class')))
                    if f == fold and c == cls]
            values = [(table.column(metric)[i], i) for i in rows
                      if not math.isnan(table.column(metric)[i])]
            if rows and not values:
                raise ValueError(f'fold {fold}, class {cls}: every {metric} is NaN')
            if values:
                top = max(v for v, _i in values)
                best.append(next(i for v, i in values if v == top))
    return table.take(best)


def box_data(best: Table, metric: str) -> List[dict]:
    """One box per class of CLASS_ORDER that has rows: its values (fold
    order) and boxplot statistics."""
    boxes = []
    for cls in CLASS_ORDER:
        values = [float(v) for v, c in zip(best.column(metric), best.column('Class')) if c == cls]
        if values:
            boxes.append({'class': cls, 'values': values, 'stats': boxplot_stats(values)})
    return boxes


def render_svg(boxes: List[dict], metric_name: str) -> bytes:
    """Boxes without fliers on octseg's axis (0.5-1)."""
    svg = _Svg(700, 700, (0.5, len(boxes) + 0.5), (0.5, 1), bottom=140)
    svg.axes('', metric_name, xticks=[],
             yticks=[(v / 10, f'{v / 10:.1f}') for v in range(5, 11)])
    half = 0.4 * (svg.px(1) - svg.px(0))
    for i, (box, color) in enumerate(zip(boxes, COLORS), 1):
        st, x = box['stats'], svg.px(i)
        top, bot = svg.py(st['q3']), svg.py(st['q1'])
        svg.add(f'<line x1="{x:.2f}" y1="{svg.py(st["whislo"]):.2f}" x2="{x:.2f}" '
                f'y2="{svg.py(st["whishi"]):.2f}" stroke="#444" stroke-width="2"/>')
        svg.add(f'<rect x="{x - half:.2f}" y="{top:.2f}" width="{2 * half:.2f}" '
                f'height="{max(bot - top, 0):.2f}" fill="{_rgb(color)}" stroke="#444" '
                f'stroke-width="2"/>')
        svg.add(f'<line x1="{x - half:.2f}" y1="{svg.py(st["med"]):.2f}" x2="{x + half:.2f}" '
                f'y2="{svg.py(st["med"]):.2f}" stroke="#444" stroke-width="2"/>')
        svg.text(x, svg.y0 + 14, box['class'], anchor='end', rotate=-90)
    return svg.document()


@entry_point('draw_boxplots')
def main(cfg: Config) -> dict:
    """Write best_metrics.csv and the figure; returns their paths and the
    boxes."""
    save_dir = octseg_torch.project_path(cfg.save_dir)
    os.makedirs(save_dir, exist_ok=True)
    class_dirs = [octseg_torch.project_path(d) for d in cfg.class_dirs]
    table = read_model_metrics(get_file_list(class_dirs, '.csv', filename_template='metrics'))
    best = get_best_epoch(rows_where(table, 'Split', cfg.split), metric=cfg.metric)
    csv_path = os.path.join(save_dir, 'best_metrics.csv')
    best.to_csv(csv_path)
    boxes = box_data(best, cfg.metric)
    svg_path = os.path.join(save_dir, f'Boxplot_{cfg.metric}_{cfg.split}.svg')
    with open(svg_path, 'wb') as f:
        f.write(render_svg(boxes, 'DSC' if cfg.metric == 'Dice' else cfg.metric))
    log.info('Complete')
    return {'best_metrics': csv_path, 'figure': svg_path, 'boxes': boxes}


if __name__ == '__main__':
    main()
