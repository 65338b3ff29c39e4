"""Analytics figures: object presence map, area traces, area boxplots and the
frame viewer composite (the port of octseg/analyze/figures.py).

octseg draws the first three with matplotlib, which the card's machine does
not have: here each figure's plotted data comes from a function of its own
(``object_map_data``, ``trace_area_data``, ``plot_area_data``) and a small
writer turns it into an SVG document. The grouping is octseg's: per class,
instance runs split where the object id changes; traces and boxes only for
instances spanning at least 3 frames; the class colours of the registry.
The boxes are what ``ax.boxplot`` draws (matplotlib's ``boxplot_stats``:
quartiles by linear interpolation, whiskers at the last data within 1.5 IQR
of the box, fliers beyond them, the notch interval med +- 1.57 IQR /
sqrt(n)).

``get_img_show`` is Pillow's two pastes with an 'L' mask (``paste_solid``),
encoded by the port's PNG writer: its pixels equal octseg's.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape

import numpy as np

from octseg_torch.core.registry import CLASS_COLORS_RGB, CLASS_IDS_REVERSED
from octseg_torch.data.image import _decode_png, encode_png, paste_solid, read_png


def _instance_runs(obj: Dict[str, list], with_area: bool = False) -> List[list]:
    """Split a class's per-frame records into instance runs (object_id
    change boundaries)."""
    runs: List[list] = []
    if not obj['object_id']:
        return runs
    current_id = obj['object_id'][0]
    run: list = []
    for idx, oid in enumerate(obj['object_id']):
        item = (obj['slice'][idx], obj['area'][idx]) if with_area else obj['slice'][idx]
        if oid == current_id:
            run.append(item)
        else:
            runs.append(run)
            run = [item]
            current_id = oid
    runs.append(run)
    return runs


# ------------------------------ plotted data -------------------------------

def object_map_data(data: Dict) -> List[dict]:
    """One line per instance run: its class, colour and slices (plotted at
    the class's row)."""
    return [{'class': class_name, 'color': CLASS_COLORS_RGB[class_name], 'slices': list(run)}
            for class_name, obj in data['objects'].items() for run in _instance_runs(obj)]


def trace_area_data(classes: Sequence[str], data: Dict) -> List[dict]:
    """Area against slice per instance of the chosen classes spanning at
    least 3 frames."""
    out = []
    for class_name, obj in data['objects'].items():
        if class_name not in classes:
            continue
        for run in _instance_runs(obj, with_area=True):
            if len(run) >= 3:
                out.append({'class': class_name, 'color': CLASS_COLORS_RGB[class_name],
                            'slices': [s for s, _a in run], 'areas': [a for _s, a in run]})
    return out


def boxplot_stats(x: Sequence[float], whis: float = 1.5) -> dict:
    """matplotlib's ``cbook.boxplot_stats`` of one sample: mean, the
    quartiles (linear interpolation), iqr, whiskers (the extreme data within
    ``whis`` IQR of the box, or the quartile where there are none), fliers
    (low ones first) and the notch interval."""
    x = np.asarray(x, np.float64).ravel()
    q1, med, q3 = np.percentile(x, [25, 50, 75])
    iqr = q3 - q1
    notch = 1.57 * iqr / np.sqrt(len(x))
    loval, hival = q1 - whis * iqr, q3 + whis * iqr
    wiskhi, wisklo = x[x <= hival], x[x >= loval]
    whishi = q3 if len(wiskhi) == 0 or np.max(wiskhi) < q3 else np.max(wiskhi)
    whislo = q1 if len(wisklo) == 0 or np.min(wisklo) > q1 else np.min(wisklo)
    return {'mean': np.mean(x), 'iqr': iqr, 'cilo': med - notch, 'cihi': med + notch,
            'whishi': whishi, 'whislo': whislo,
            'fliers': np.concatenate([x[x < whislo], x[x > whishi]]),
            'q1': q1, 'med': med, 'q3': q3}


def plot_area_data(classes: Sequence[str], data: Dict) -> List[dict]:
    """One box per instance of the chosen classes spanning at least 3
    frames: its label '<class>, <instance number from 1>', colour, areas and
    ``boxplot_stats``."""
    out = []
    for class_name, obj in data['objects'].items():
        if class_name not in classes:
            continue
        for i, run in enumerate(_instance_runs(obj, with_area=True), 1):
            if len(run) >= 3:
                areas = [a for _s, a in run]
                out.append({'label': f'{class_name}, {i}',
                            'color': CLASS_COLORS_RGB[class_name], 'areas': areas,
                            'stats': boxplot_stats(areas)})
    return out


# ------------------------------- SVG writer --------------------------------

class _Svg:
    """A plot area with linear axes inside a fixed-size SVG document."""

    def __init__(self, width: int, height: int, xlim: Tuple[float, float],
                 ylim: Tuple[float, float], left: int = 70, bottom: int = 45):
        self.w, self.h = width, height
        self.x0, self.x1 = left, width - 15
        self.y0, self.y1 = height - bottom, 15
        lo, hi = xlim
        self.xlim = (lo, hi) if hi > lo else (lo - 0.5, lo + 0.5)
        lo, hi = ylim
        self.ylim = (lo, hi) if hi > lo else (lo - 0.5, lo + 0.5)
        self.parts: List[str] = []

    def px(self, x: float) -> float:
        a, b = self.xlim
        return self.x0 + (x - a) / (b - a) * (self.x1 - self.x0)

    def py(self, y: float) -> float:
        a, b = self.ylim
        return self.y0 - (y - a) / (b - a) * (self.y0 - self.y1)

    def add(self, element: str) -> None:
        self.parts.append(element)

    def polyline(self, xs, ys, color, width: float = 2, markers: bool = False) -> None:
        pts = ' '.join(f'{self.px(x):.2f},{self.py(y):.2f}' for x, y in zip(xs, ys))
        rgb = _rgb(color)
        self.add(f'<polyline points="{pts}" fill="none" stroke="{rgb}" '
                 f'stroke-width="{width}"/>')
        if markers:
            for x, y in zip(xs, ys):
                self.add(f'<circle cx="{self.px(x):.2f}" cy="{self.py(y):.2f}" r="3" '
                         f'fill="{rgb}"/>')

    def text(self, x: float, y: float, s: str, anchor: str = 'middle', rotate: float = 0
             ) -> None:
        rot = f' transform="rotate({rotate} {x:.2f} {y:.2f})"' if rotate else ''
        self.add(f'<text x="{x:.2f}" y="{y:.2f}" font-size="11" text-anchor="{anchor}"'
                 f'{rot}>{escape(s)}</text>')

    def axes(self, xlabel: str, ylabel: str, xticks=None, yticks=None) -> None:
        self.add(f'<rect x="{self.x0}" y="{self.y1}" width="{self.x1 - self.x0}" '
                 f'height="{self.y0 - self.y1}" fill="none" stroke="#000"/>')
        for v, label in (xticks if xticks is not None else _ticks(self.xlim)):
            x = self.px(v)
            self.add(f'<line x1="{x:.2f}" y1="{self.y0}" x2="{x:.2f}" y2="{self.y0 + 4}" '
                     f'stroke="#000"/>')
            self.text(x, self.y0 + 16, label)
        for v, label in (yticks if yticks is not None else _ticks(self.ylim)):
            y = self.py(v)
            self.add(f'<line x1="{self.x0 - 4}" y1="{y:.2f}" x2="{self.x0}" y2="{y:.2f}" '
                     f'stroke="#000"/>')
            self.text(self.x0 - 7, y + 4, label, anchor='end')
        self.text((self.x0 + self.x1) / 2, self.h - 6, xlabel)
        self.text(14, (self.y0 + self.y1) / 2, ylabel, rotate=-90)

    def document(self) -> bytes:
        head = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{self.w}" '
                f'height="{self.h}" viewBox="0 0 {self.w} {self.h}" '
                f'font-family="sans-serif"><rect width="100%" height="100%" fill="#fff"/>')
        return (head + ''.join(self.parts) + '</svg>').encode()


def _rgb(color) -> str:
    return 'rgb({},{},{})'.format(*color)


def _ticks(lim: Tuple[float, float], n: int = 6) -> List[Tuple[float, str]]:
    lo, hi = lim
    step = float(10 ** np.floor(np.log10((hi - lo) / n)))
    for m in (1, 2, 5, 10):
        if (hi - lo) / (m * step) <= n:
            step *= m
            break
    first = np.ceil(lo / step) * step
    return [(float(v), f'{v:g}') for v in np.arange(first, hi + step / 2, step)]


def _span(values: Sequence[float], pad: float = 0.05) -> Tuple[float, float]:
    lo, hi = (float(min(values)), float(max(values))) if len(values) else (0.0, 1.0)
    extra = (hi - lo) * pad
    return lo - extra, hi + extra


def get_object_map(data: Dict) -> bytes:
    """Per-class object presence across slices, an SVG document."""
    lines = object_map_data(data)
    rows = list(dict.fromkeys(line['class'] for line in lines))   # first plotted first
    hi = max((max(line['slices']) for line in lines), default=1)
    svg = _Svg(990, 275, (0, hi * 1.05 if hi else 1), (-0.5, max(len(rows), 1) - 0.5),
               left=110)
    svg.axes('Slice', '', yticks=[(i, c) for i, c in enumerate(rows)])
    for line in lines:
        row = rows.index(line['class'])
        svg.polyline(line['slices'], [row] * len(line['slices']), line['color'], markers=True)
    return svg.document()


def get_trace_area(classes: Sequence[str], data: Dict) -> bytes:
    """Area against slice per instance spanning >= 3 frames, an SVG
    document."""
    traces = trace_area_data(classes, data)
    svg = _Svg(990, 385, _span([s for t in traces for s in t['slices']]),
               _span([a for t in traces for a in t['areas']]))
    svg.axes('Samples', 'Area')
    for t in traces:
        svg.polyline(t['slices'], t['areas'], t['color'])
    return svg.document()


def get_plot_area(classes: Sequence[str], data: Dict) -> bytes:
    """Per-instance area boxplots (instances spanning >= 3 frames), an SVG
    document."""
    boxes = plot_area_data(classes, data)
    values = [v for b in boxes for v in (b['stats']['whislo'], b['stats']['whishi'],
                                          *b['stats']['fliers'])]
    svg = _Svg(990, 385, (0.5, len(boxes) + 0.5), _span(values), bottom=90)
    svg.axes('Objects', 'Area', xticks=[])
    for i, b in enumerate(boxes, 1):
        st, rgb = b['stats'], _rgb(b['color'])
        x, half = svg.px(i), 0.25 * (svg.px(1) - svg.px(0))
        top, bot = svg.py(st['q3']), svg.py(st['q1'])
        svg.add(f'<line x1="{x:.2f}" y1="{svg.py(st["whislo"]):.2f}" x2="{x:.2f}" '
                f'y2="{svg.py(st["whishi"]):.2f}" stroke="#000"/>')
        svg.add(f'<rect x="{x - half:.2f}" y="{top:.2f}" width="{2 * half:.2f}" '
                f'height="{max(bot - top, 0):.2f}" fill="{rgb}" stroke="#000"/>')
        svg.add(f'<line x1="{x - half:.2f}" y1="{svg.py(st["med"]):.2f}" '
                f'x2="{x + half:.2f}" y2="{svg.py(st["med"]):.2f}" stroke="#f80" '
                f'stroke-width="2"/>')
        for f in st['fliers']:
            svg.add(f'<circle cx="{x:.2f}" cy="{svg.py(f):.2f}" r="3" fill="none" '
                    f'stroke="#000"/>')
        svg.text(x, svg.y0 + 14, b['label'], anchor='end', rotate=-30)
    return svg.document()


def get_img_show(data: Dict, img_dir: str, img_num: int = 0,
                 classes_vis: Optional[List[str]] = None, opacity: float = 20) -> bytes:
    """Side-by-side frame view as PNG bytes: the frame with translucent class
    fills, and a gray canvas with opaque fills."""
    alpha = opacity * 0.01
    img = read_png(f"{img_dir}/{data['images'][img_num]}.png")[..., ::-1]   # RGB
    h, w = img.shape[:2]
    left = np.ascontiguousarray(img)
    right = np.full((h, w, 3), 128, np.uint8)
    classes_vis = classes_vis if classes_vis is not None else list(CLASS_IDS_REVERSED.values())
    for _class_id, class_name in CLASS_IDS_REVERSED.items():
        if class_name not in classes_vis:
            continue
        obj = data['objects'][class_name]
        if img_num not in obj['slice']:
            continue
        i = obj['slice'].index(img_num)
        samples, _color, _depth, _plte = _decode_png(base64.b64decode(obj['masks'][i]),
                                                     '<mask>')
        mask = samples[..., 0]
        color = CLASS_COLORS_RGB[class_name]
        paste_solid(left, color, (mask > 0).astype(np.uint8) * int(255 * (1 - alpha)))
        paste_solid(right, color, mask)
    return encode_png(np.concatenate([left, right], axis=1))
