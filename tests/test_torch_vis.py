"""octseg_torch.vis (the CV-study figures) against octseg.vis, seaborn and
matplotlib.

The inputs are per-fold ``metrics.csv`` files (octseg's training schema)
written from a seeded numpy generator: five folds of 12 epochs under a
class directory, with Lumen, Lipid core and Mean rows, and a file outside any
``fold_N`` directory. What is held is the plotted data, not pixels:

- draw_loss_plot: the merged rows of the class equal pandas'; each line's
  per-epoch means equal the line seaborn 0.13.2's ``lineplot`` draws, and
  its 95% band equals the band seaborn draws when given the same ``seed``
  (read back from the figure's artists); a control with another seed must
  differ;
- draw_boxplots: ``best_metrics.csv`` is byte-equal to the file octseg's
  ``main`` writes; the fold ids (fold 0 and a warning for a path without
  one); each class's box statistics equal
  ``matplotlib.cbook.boxplot_stats(whis=1.5)`` in CLASS_ORDER;
- both entry points write their SVG under octseg's file stem.
"""

import logging
import os
import xml.etree.ElementTree as ET

import matplotlib

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import seaborn as sns  # noqa: E402
from matplotlib import cbook  # noqa: E402

from octseg.core.config import Config as JaxConfig  # noqa: E402
from octseg.vis import draw_boxplots as jax_boxplots  # noqa: E402
from octseg.vis import draw_loss_plot as jax_loss_plot  # noqa: E402
from octseg_torch.core.config import Config  # noqa: E402
from octseg_torch.vis import draw_boxplots, draw_loss_plot  # noqa: E402

COLUMNS = ['Epoch', 'Loss', 'IoU', 'Dice', 'Precision', 'Recall', 'F1', 'Split', 'Class']
EPOCHS = 12
# five values per epoch: with three, the 2.5th percentile of 1000 resample
# means is the smallest value whatever the seed (1 resample in 27 draws it
# three times), and the seed control could not fail
FOLDS = 5


def _write_metrics(path, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for epoch in range(1, EPOCHS + 1):
        for split in ('train', 'test'):
            loss = float(np.exp(-epoch / 5) + rng.uniform(0, 0.1))
            for cls in ('Lumen', 'Lipid core', 'Mean'):
                iou = float(rng.uniform(0.4, 0.95))
                dice = 2 * iou / (iou + 1)
                rows.append([epoch, loss, iou, dice, float(rng.uniform(0.5, 1)),
                             float(rng.uniform(0.5, 1)), dice, split, cls])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pd.DataFrame(rows, columns=COLUMNS).to_csv(path, index=False)


@pytest.fixture(scope='module')
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp('study')
    class_dir = root / 'Lumen'
    for k in range(1, FOLDS + 1):
        _write_metrics(str(class_dir / f'fold_{k}' / 'metrics.csv'), k)
    other = root / 'Lipid core'
    _write_metrics(str(other / 'fold_1' / 'metrics.csv'), 11)
    _write_metrics(str(other / 'extra' / 'metrics.csv'), 12)   # no fold id
    return root


def _seaborn_line(df, metric, seed):
    """(x, mean, band low, band high) of seaborn's lineplot of ``metric``,
    read from the figure."""
    fig = plt.figure()
    ax = sns.lineplot(data=df, x='Epoch', y=metric, err_style='band', errorbar=('ci', 95),
                      seed=seed)
    x, mean = ax.lines[0].get_xydata().T
    verts = ax.collections[0].get_paths()[0].vertices
    low = [verts[verts[:, 0] == v, 1].min() for v in x]
    high = [verts[verts[:, 0] == v, 1].max() for v in x]
    plt.close(fig)
    return x, mean, np.array(low), np.array(high)


def test_merged_rows_equal_pandas(study):
    class_dir = str(study / 'Lumen')
    data = draw_loss_plot.loss_plot_data(class_dir, 'Loss', 'Dice')
    paths = jax_loss_plot.get_file_list(class_dir, '.csv', filename_template='metrics')
    df = jax_loss_plot.merge_metric_dataframes(paths)
    df = df[df['Class'] == 'Lumen']
    rows = data['rows']
    assert data['class'] == 'Lumen' and rows.columns == list(df.columns)
    assert len(rows) == len(df) == FOLDS * EPOCHS * 2
    for c in df.columns:
        assert rows.column(c) == df[c].tolist(), c


@pytest.mark.parametrize('split,metric', [('train', 'Loss'), ('test', 'Dice')])
def test_lines_and_bands_equal_seaborns_with_the_same_seed(study, split, metric):
    class_dir = str(study / 'Lumen')
    seed = 5
    data = draw_loss_plot.loss_plot_data(class_dir, metric if split == 'train' else 'Loss',
                                         metric if split == 'test' else 'Loss', seed=seed)
    line = data[split]
    df = jax_loss_plot.merge_metric_dataframes(
        jax_loss_plot.get_file_list(class_dir, '.csv', filename_template='metrics'))
    df = df[(df['Class'] == 'Lumen') & (df['Split'] == split)]
    x, mean, low, high = _seaborn_line(df, metric, seed)
    np.testing.assert_array_equal(line['epochs'], x)
    np.testing.assert_array_equal(line['mean'], mean)
    np.testing.assert_array_equal(line['low'], low)
    np.testing.assert_array_equal(line['high'], high)
    assert (np.array(line['high']) > np.array(line['low'])).all()
    # control: another seed draws other resamples
    other = draw_loss_plot.line_data(data['rows'], split, metric, seed + 1)
    assert other['mean'] == line['mean'] and other['low'] != line['low']


def test_bootstrap_of_one_value_has_no_band():
    assert all(np.isnan(draw_loss_plot.bootstrap_interval([0.5], 0)))


def test_loss_plot_entry_point_writes_the_svg(study, tmp_path):
    path = draw_loss_plot.main(Config(class_dir=str(study / 'Lumen'), save_dir=str(tmp_path),
                                      train_metric='Loss', test_metric='Dice', seed=0))
    assert os.path.basename(path) == 'Loss_Dice_Lumen.svg'
    root = ET.parse(path).getroot()
    assert root.tag.endswith('svg') and len(root) > 10


def test_best_metrics_csv_is_byte_equal_to_octsegs(study, tmp_path):
    dirs = [str(study / 'Lumen'), str(study / 'Lipid core')]
    got = draw_boxplots.main(Config(class_dirs=dirs, save_dir=str(tmp_path / 'port'),
                                    split='test', metric='Dice'))
    jax_boxplots.main(JaxConfig(class_dirs=dirs, save_dir=str(tmp_path / 'octseg'),
                                split='test', metric='Dice', dpi=10))
    with open(got['best_metrics'], 'rb') as f, \
            open(tmp_path / 'octseg' / 'best_metrics.csv', 'rb') as g:
        assert f.read() == g.read()
    assert os.path.basename(got['figure']) == 'Boxplot_Dice_test.svg'
    ET.parse(got['figure'])


def test_fold_ids_and_best_rows(study, caplog):
    assert [draw_boxplots.get_fold_id(p) for p in ('a/fold_3/m.csv', 'fold_12', 'x/y')] == [
        3, 12, None]
    paths = [str(study / 'Lumen' / 'fold_2' / 'metrics.csv'),
             str(study / 'Lipid core' / 'extra' / 'metrics.csv')]
    with caplog.at_level(logging.WARNING):
        got = draw_boxplots.read_model_metrics(paths)
    assert any('no fold_N in path' in r.getMessage() for r in caplog.records)
    want = jax_boxplots.read_model_metrics(paths)
    assert got.columns == list(want.columns) and got.column('Fold') == want['Fold'].tolist()
    for metric in ('Dice', 'Loss'):
        best = draw_boxplots.get_best_epoch(got, metric)
        want_best = jax_boxplots.get_best_epoch(want, metric)
        for c in want_best.columns:
            assert best.column(c) == want_best[c].tolist(), (metric, c)


def test_box_statistics_equal_matplotlibs(study):
    dirs = [str(study / 'Lumen'), str(study / 'Lipid core')]
    table = draw_boxplots.read_model_metrics(
        draw_boxplots.get_file_list(dirs, '.csv', filename_template='metrics'))
    best = draw_boxplots.get_best_epoch(draw_boxplots.rows_where(table, 'Split', 'test'), 'IoU')
    boxes = draw_boxplots.box_data(best, 'IoU')
    assert [b['class'] for b in boxes] == ['Lumen', 'Lipid core']
    for box in boxes:
        want, = cbook.boxplot_stats(np.asarray(box['values']), whis=1.5)
        for key in ('mean', 'iqr', 'cilo', 'cihi', 'whishi', 'whislo', 'q1', 'med', 'q3'):
            assert box['stats'][key] == want[key], key
        np.testing.assert_array_equal(box['stats']['fliers'], want['fliers'])
