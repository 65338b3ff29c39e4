"""A small table with pandas' CSV semantics, without pandas.

octseg reads and writes its CSVs through pandas (the sweep aggregator, the
DICOM metadata, the interim and fold metadata); ``Table`` keeps the
behaviours those files depend on, so the port's files are byte-equal:
read_csv's float parser and type inference (ints, floats, bools, strings;
its NA strings and empty cells read as NaN; an int column with a NaN
becomes float, written ``3.0``; a blank header cell named ``Unnamed: i``),
a frame built from
records (None as NaN; ints with a NaN become float), concat's column union
in order of appearance with NaN in the gaps, sort_values' stable multi-key
sort with NaN last, and to_csv with floats written as ``repr`` and an
optional 1-based index column.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Any, Dict, List, Optional, Sequence

# pandas.read_csv's default NA strings
_NA_STRINGS = {'', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
               '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
               'nan', 'null'}
_INT = re.compile(r'[+-]?\d+')
_TRUE, _FALSE = {'True', 'TRUE', 'true'}, {'False', 'FALSE', 'false'}
NAN = float('nan')


def _is_na(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


_DECIMAL = re.compile(r'\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*')
_POW10 = [float(f'1e{k}') for k in range(309)]


def _read_float(s: str) -> float:
    """``s`` as pandas' C parser reads a float by default
    (``precise_xstrtod``): at most 17 digits accumulated as ``n * 10 + d``
    in doubles, then one multiplication or division by a power of ten. A
    17-digit value may come out an ulp from Python's correctly rounded
    ``float(s)``; forms that are not plain decimals go to ``float``."""
    m = _DECIMAL.fullmatch(s)
    if m is None or not (m.group(2) or m.group(3)):
        return float(s)
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, int(exp or 0)
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or '')[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        exponent -= 1
    if sign == '-':
        number = -number
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_float(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        return None


class Table:
    """Columns of Python values with a pandas dtype each: ``int``, ``float``
    (missing values NaN), ``bool`` or ``object`` (missing values NaN)."""

    def __init__(self, columns: Sequence[str], data: Dict[str, list], kinds: Dict[str, str]):
        self.columns = list(columns)
        self.data = data
        self.kinds = kinds

    def __len__(self) -> int:
        return len(self.data[self.columns[0]]) if self.columns else 0

    @classmethod
    def read_csv(cls, path: str) -> 'Table':
        with open(path, newline='') as f:
            rows = [r for r in csv.reader(f) if r]
        # pandas names a blank header cell 'Unnamed: {i}'
        header = [h or f'Unnamed: {i}' for i, h in enumerate(rows[0])]
        rows = rows[1:]
        data, kinds = {}, {}
        for i, name in enumerate(header):
            kinds[name], data[name] = cls._infer([r[i] if i < len(r) else '' for r in rows])
        return cls(header, data, kinds)

    @staticmethod
    def _infer(cells: List[str]):
        present = [c for c in cells if c not in _NA_STRINGS]
        has_na = len(present) < len(cells)
        if present and all(_INT.fullmatch(c) for c in present):
            if not has_na:
                return 'int', [int(c) for c in cells]
            return 'float', [NAN if c in _NA_STRINGS else float(int(c)) for c in cells]
        if all(_parse_float(c) is not None for c in present):
            return 'float', [NAN if c in _NA_STRINGS else _read_float(c) for c in cells]
        if all(c in _TRUE or c in _FALSE for c in present):
            values = [NAN if c in _NA_STRINGS else c in _TRUE for c in cells]
            return ('object' if has_na else 'bool'), values
        return 'object', [NAN if c in _NA_STRINGS else c for c in cells]

    @staticmethod
    def _kind_of_values(values: list) -> str:
        """pandas' inference over Python values (a DataFrame built from
        rows, or from records)."""
        present = [v for v in values if not _is_na(v)]
        has_na = len(present) < len(values)
        if present and all(isinstance(v, bool) for v in present):
            return 'object' if has_na else 'bool'
        if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
            if present and all(isinstance(v, int) for v in present) and not has_na:
                return 'int'
            return 'float'
        return 'object'

    @classmethod
    def from_rows(cls, columns: Sequence[str], rows: List[dict]) -> 'Table':
        data, kinds = {}, {}
        for c in columns:
            values = [NAN if _is_na(r.get(c)) else r.get(c) for r in rows]
            kinds[c] = cls._kind_of_values(values)
            data[c] = [float(v) if kinds[c] == 'float' and not _is_na(v) else v
                       for v in values]
        return cls(columns, data, kinds)

    @classmethod
    def concat(cls, tables: List['Table']) -> 'Table':
        columns: List[str] = []
        for t in tables:
            columns += [c for c in t.columns if c not in columns]
        data, kinds = {}, {}
        for c in columns:
            parts = [t.kinds.get(c, 'missing') for t in tables]
            present = {k for k in parts if k != 'missing'}
            if len(present) == 1 and 'missing' not in parts:
                kind = present.pop()
            elif present <= {'int', 'float'}:
                kind = 'float'
            else:
                kind = 'object'
            values: list = []
            for t in tables:
                col = t.data.get(c, [NAN] * len(t))
                values += [float(v) if kind == 'float' and not _is_na(v) else v for v in col]
            data[c], kinds[c] = values, kind
        return cls(columns, data, kinds)

    def add_column(self, name: str, value: Any) -> None:
        if name not in self.columns:
            self.columns.append(name)
        self.data[name] = [value] * len(self)
        self.kinds[name] = self._kind_of_values([value])

    def row(self, i: int) -> dict:
        return {c: self.data[c][i] for c in self.columns}

    def rows(self) -> List[dict]:
        return [self.row(i) for i in range(len(self))]

    @staticmethod
    def _cell(v: Any) -> str:
        if _is_na(v):
            return ''
        if isinstance(v, float):
            return repr(v)
        return str(v)

    def column(self, name: str) -> list:
        return self.data[name]

    def unique(self, name: str) -> list:
        """The column's distinct values in order of appearance."""
        return list(dict.fromkeys(self.data[name]))

    def take(self, indices: Sequence[int]) -> 'Table':
        """The rows at ``indices``, in that order (the kinds kept)."""
        return Table(self.columns, {c: [self.data[c][i] for i in indices] for c in self.columns},
                     dict(self.kinds))

    def drop(self, names: Sequence[str]) -> 'Table':
        """Without the columns ``names`` (absent ones ignored)."""
        keep = [c for c in self.columns if c not in names]
        return Table(keep, {c: self.data[c] for c in keep}, {c: self.kinds[c] for c in keep})

    def sort_values(self, keys: Sequence[str]) -> 'Table':
        """Rows sorted by ``keys`` ascending, NaN last within each key,
        stable (pandas' multi-key sort)."""
        order = list(range(len(self)))
        for key in reversed(keys):
            col = self.data[key]
            order.sort(key=lambda i: (1, 0) if _is_na(col[i]) else (0, col[i]))
        return self.take(order)

    def to_csv(self, path: str, index_label: Optional[str] = None) -> None:
        """Write the table; with ``index_label``, a first column of that
        name holding 1, 2, ... (pandas' index after ``reset_index`` and
        ``index += 1``)."""
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f, lineterminator='\n')
            writer.writerow(([index_label] if index_label else []) + self.columns)
            for i in range(len(self)):
                writer.writerow(([str(i + 1)] if index_label else [])
                                + [self._cell(self.data[c][i]) for c in self.columns])
