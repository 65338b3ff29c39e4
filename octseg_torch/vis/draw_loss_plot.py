"""Training-curve figure: a train metric and a test metric per epoch, each
the mean over the folds with a 95% bootstrap confidence band.

The port of octseg/vis/draw_loss_plot.py, without pandas, matplotlib or
seaborn: the per-fold ``metrics.csv`` files under ``class_dir`` are merged
(``core/table.Table``) and filtered to the class the directory is named
after; per split and epoch the line is the mean, and the band is what
seaborn 0.13.2's ``lineplot(errorbar=('ci', 95))`` draws: the epoch's values
in ascending order (lineplot sorts its rows by x, then y), 1000 means of
resamples with replacement (``algorithms.bootstrap``: a fresh
``np.random.default_rng(seed)`` per epoch, ``integers(0, n, n)`` per
resample), cut at their 2.5th and 97.5th percentiles (``nanpercentile``);
no band for a single value. octseg passes no seed, so its bands change from
run to run; here ``seed`` (default 0) fixes them. The figure is an SVG
(``analyze/figures.py``'s writer) with octseg's file stem.

Config: configs/draw_loss_plot.yaml.
Usage: python -m octseg_torch.vis.draw_loss_plot class_dir=<dir of fold metrics.csv, named
    after the class> save_dir=<dir> [seed=0]
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

import octseg_torch
from octseg_torch.analyze.figures import _rgb, _Svg
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.table import Table
from octseg_torch.data.utils import get_file_list

log = logging.getLogger(__name__)

N_BOOT = 1000
CI_WIDTH = 95.0
# seaborn's 'bright' palette, its first two colours
COLORS = ((2, 62, 255), (255, 124, 0))


def merge_metric_tables(csv_paths: Sequence[str]) -> Table:
    """The rows of every ``metrics.csv``, in path order (pandas' concat)."""
    return Table.concat([Table.read_csv(p) for p in csv_paths])


def bootstrap_interval(values: Sequence[float], seed, n_boot: int = N_BOOT,
                       width: float = CI_WIDTH) -> Tuple[float, float]:
    """(low, high) of the ``width``% percentile interval of ``n_boot``
    bootstrap means of ``values`` (NaN, NaN for fewer than two values)."""
    vals = np.asarray(values, np.float64)
    n = len(vals)
    if n <= 1:
        return math.nan, math.nan
    rng = np.random.default_rng(seed)
    mean = np.nanmean if np.isnan(np.sum(vals)) else np.mean
    boots = np.array([mean(vals.take(rng.integers(0, n, n, dtype=np.intp)))
                      for _ in range(int(n_boot))])
    edge = (100 - width) / 2
    low, high = np.nanpercentile(boots, (edge, 100 - edge))
    return float(low), float(high)


def line_data(table: Table, split: str, metric: str, seed) -> Dict[str, List[float]]:
    """One line of the figure: the epochs of ``split`` in ascending order,
    the mean of ``metric`` at each and its band. Rows missing the epoch or
    the metric are dropped, and each epoch's values sorted, as seaborn does
    (the order fixes which values a resample draws)."""
    by_epoch: Dict[float, List[float]] = {}
    for row in table.rows():
        x, y = row['Epoch'], row[metric]
        if row['Split'] != split or _missing(x) or _missing(y):
            continue
        by_epoch.setdefault(x, []).append(float(y))
    epochs = sorted(by_epoch)
    by_epoch = {e: sorted(v) for e, v in by_epoch.items()}
    bands = [bootstrap_interval(by_epoch[e], seed) for e in epochs]
    return {'epochs': [float(e) for e in epochs],
            'mean': [float(np.mean(np.asarray(by_epoch[e], np.float64))) for e in epochs],
            'low': [b[0] for b in bands], 'high': [b[1] for b in bands]}


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def loss_plot_data(class_dir: str, train_metric: str, test_metric: str, seed=0) -> dict:
    """The plotted data: the class, its merged rows and the two lines."""
    table = merge_metric_tables(get_file_list(class_dir, '.csv', filename_template='metrics'))
    class_name = os.path.basename(class_dir.rstrip('/'))
    rows = table.take([i for i, c in enumerate(table.column('Class')) if c == class_name])
    return {'class': class_name, 'rows': rows,
            'train': line_data(rows, 'train', train_metric, seed),
            'test': line_data(rows, 'test', test_metric, seed)}


def render_svg(data: dict, train_label: str, test_label: str) -> bytes:
    """The figure: octseg's axes (epochs 0-125, metric 0-1), each line over
    its band, a legend."""
    svg = _Svg(800, 660, (0, 125), (0, 1))
    svg.axes('Epoch', 'Metric Value', xticks=[(v, str(v)) for v in range(0, 126, 25)],
             yticks=[(v / 5, f'{v / 5:.1f}') for v in range(6)])
    for (split, label), color in zip((('train', train_label), ('test', test_label)), COLORS):
        line = data[split]
        spans = [(x, lo, hi) for x, lo, hi in zip(line['epochs'], line['low'], line['high'])
                 if not (math.isnan(lo) or math.isnan(hi))]
        if spans:
            pts = [(x, hi) for x, _lo, hi in spans] + [(x, lo) for x, lo, _hi in spans[::-1]]
            svg.add('<polygon points="{}" fill="{}" fill-opacity="0.2" stroke="none"/>'.format(
                ' '.join(f'{svg.px(x):.2f},{svg.py(y):.2f}' for x, y in pts), _rgb(color)))
        svg.polyline(line['epochs'], line['mean'], color, width=3)
        y = svg.y1 + 20 + 18 * (split == 'test')
        svg.add(f'<line x1="{svg.x1 - 150}" y1="{y}" x2="{svg.x1 - 125}" y2="{y}" '
                f'stroke="{_rgb(color)}" stroke-width="3"/>')
        svg.text(svg.x1 - 120, y + 4, f'{label} ({split.capitalize()})', anchor='start')
    return svg.document()


@entry_point('draw_loss_plot')
def main(cfg: Config) -> str:
    """Write the figure; returns its path."""
    class_dir = octseg_torch.project_path(cfg.class_dir)
    save_dir = octseg_torch.project_path(cfg.save_dir)
    os.makedirs(save_dir, exist_ok=True)
    data = loss_plot_data(class_dir, cfg.train_metric, cfg.test_metric, cfg.get('seed', 0))
    train_label = 'DSC' if cfg.train_metric == 'Dice' else cfg.train_metric
    test_label = 'DSC' if cfg.test_metric == 'Dice' else cfg.test_metric
    name = data['class'].replace(' ', '_')
    save_path = os.path.join(save_dir, f'{cfg.train_metric}_{cfg.test_metric}_{name}.svg')
    with open(save_path, 'wb') as f:
        f.write(render_svg(data, train_label, test_label))
    log.info('%s plot saved', data['class'])
    log.info('Complete')
    return save_path


if __name__ == '__main__':
    main()
