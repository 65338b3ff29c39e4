"""Minimal self-contained xlsx (SpreadsheetML) reader and writer.

A copy of octseg/data/xlsxio.py (standard library only): the sweep
aggregator (``tune/get_configs.py``) reads W&B xlsx exports and writes its
tables with it, where octseg's reference used pandas with openpyxl. xlsx is
a zip of XML parts; reading needs the workbook's sheet list, the
shared-strings table and one worksheet; writing emits one worksheet of
inline strings, which pandas, openpyxl and Excel accept.

Read: shared strings (t="s"), inline strings (t="inlineStr"),
formula-cached strings (t="str"), booleans (t="b") and numbers (the
default). Dates come back as serial numbers (the aggregator drops them).
"""

from __future__ import annotations

import numbers
import zipfile
from typing import Any, Dict, List, Optional
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

_NS = '{http://schemas.openxmlformats.org/spreadsheetml/2006/main}'
_REL_NS = ('{http://schemas.openxmlformats.org/package/2006/relationships}'
           'Relationship')


def _col_index(cell_ref: str) -> int:
    """'A1' -> 0, 'AB12' -> 27."""
    col = 0
    for ch in cell_ref:
        if not ch.isalpha():
            break
        col = col * 26 + (ord(ch.upper()) - ord('A') + 1)
    return col - 1


def _cell_value(cell, shared: List[str]) -> Any:
    t = cell.get('t', 'n')
    if t == 'inlineStr':
        return ''.join(el.text or '' for el in cell.iter(f'{_NS}t'))
    v = cell.find(f'{_NS}v')
    if v is None or v.text is None:
        return None
    if t == 's':
        return shared[int(v.text)]
    if t == 'str':
        return v.text
    if t == 'b':
        return bool(int(v.text))
    try:
        f = float(v.text)
    except ValueError:  # malformed numeric cell — keep the raw text
        return v.text
    return int(f) if f.is_integer() and abs(f) < 2 ** 53 else f


def _sheet_path(z: zipfile.ZipFile, sheet: Optional[str]) -> str:
    """Resolve a sheet name (or the first sheet) to its zip member path."""
    wb = ET.fromstring(z.read('xl/workbook.xml'))
    rels = {
        rel.get('Id'): rel.get('Target')
        for rel in ET.fromstring(z.read('xl/_rels/workbook.xml.rels')).iter(_REL_NS)
    }
    rid_attr = ('{http://schemas.openxmlformats.org/officeDocument/2006/'
                'relationships}id')
    for el in wb.iter(f'{_NS}sheet'):
        if sheet is None or el.get('name') == sheet:
            target = rels[el.get(rid_attr)]
            if target.startswith('/'):  # package-absolute target
                return target[1:]
            return target if target.startswith('xl/') else 'xl/' + target
    raise KeyError(f'sheet {sheet!r} not found')


def read_xlsx(path: str, sheet: Optional[str] = None) -> List[List[Any]]:
    """Read one worksheet into a list of rows (lists of python values);
    missing cells are None and rows are padded to the widest row."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if 'xl/sharedStrings.xml' in z.namelist():
            sst = ET.fromstring(z.read('xl/sharedStrings.xml'))
            for si in sst.iter(f'{_NS}si'):
                shared.append(''.join(el.text or '' for el in si.iter(f'{_NS}t')))
        ws = ET.fromstring(z.read(_sheet_path(z, sheet)))
        by_row: Dict[int, List[Any]] = {}
        width = 0
        next_row = 0
        for row in ws.iter(f'{_NS}row'):
            # honor the row's 'r' attribute: writers may omit blank rows
            # entirely (valid SpreadsheetML) — ignoring it would shift every
            # subsequent row up relative to pandas.read_excel
            r = row.get('r')
            ri = int(r) - 1 if r else next_row
            next_row = ri + 1
            values: Dict[int, Any] = {}
            next_col = 0
            for cell in row.iter(f'{_NS}c'):
                ref = cell.get('r')
                col = _col_index(ref) if ref else next_col
                next_col = col + 1
                values[col] = _cell_value(cell, shared)
            if values:
                width = max(width, max(values) + 1)
            by_row[ri] = [values.get(i) for i in range(max(values, default=-1) + 1)]
        n_rows = max(by_row, default=-1) + 1
        return [
            (by_row.get(i, []) + [None] * width)[:width] if width else
            by_row.get(i, [])
            for i in range(n_rows)
        ]


def read_xlsx_records(path: str, sheet: Optional[str] = None) -> List[Dict[str, Any]]:
    """First row = header; returns a list of {column: value} dicts (the
    pandas.read_excel orientation the reference aggregator uses)."""
    rows = read_xlsx(path, sheet)
    if not rows:
        return []
    header = ['' if h is None else str(h) for h in rows[0]]
    # pandas names blank header cells 'Unnamed: {i}' — the W&B exports' index
    # column arrives that way and get_configs renames it to ID
    header = [h if h != '' else f'Unnamed: {i}' for i, h in enumerate(header)]
    return [dict(zip(header, r + [None] * (len(header) - len(r))))
            for r in rows[1:]]


def _col_name(idx: int) -> str:
    name = ''
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord('A') + rem) + name
    return name


def write_xlsx(path: str, rows: List[List[Any]], sheet: str = 'Sheet1') -> None:
    """Write rows to a single-sheet xlsx with inline strings."""
    cells_xml: List[str] = []
    for ri, row in enumerate(rows, start=1):
        parts = [f'<row r="{ri}">']
        for ci, val in enumerate(row):
            ref = f'{_col_name(ci)}{ri}'
            if val is None:
                continue
            # numpy scalars (np.float64/int64/bool_) repr as 'np.float64(x)'
            # under numpy 2.x and dodge numbers.Number for bool_ — unwrap to
            # native python types first
            if type(val).__module__ == 'numpy' and hasattr(val, 'item'):
                val = val.item()
            if isinstance(val, bool):
                parts.append(f'<c r="{ref}" t="b"><v>{int(val)}</v></c>')
            elif isinstance(val, numbers.Number):
                v = int(val) if float(val).is_integer() and not isinstance(
                    val, float) else float(val)
                if v != v or v in (float('inf'), float('-inf')):
                    continue  # NaN/inf: empty cell, like pandas
                parts.append(f'<c r="{ref}"><v>{v!r}</v></c>')
            else:
                s = escape(str(val))
                parts.append(
                    f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
                    f'{s}</t></is></c>')
        parts.append('</row>')
        cells_xml.append(''.join(parts))

    sheet_xml = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<worksheet xmlns="{_NS[1:-1]}"><sheetData>'
        + ''.join(cells_xml) + '</sheetData></worksheet>'
    )
    workbook_xml = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<workbook xmlns="{_NS[1:-1]}" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/'
        'relationships"><sheets>'
        f'<sheet name="{escape(sheet, {chr(34): "&quot;"})}" '
        'sheetId="1" r:id="rId1"/>'
        '</sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/worksheet" '
        'Target="worksheets/sheet1.xml"/></Relationships>'
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        'worksheet+xml"/></Types>'
    )
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as z:
        z.writestr('[Content_Types].xml', content_types)
        z.writestr('_rels/.rels', root_rels)
        z.writestr('xl/workbook.xml', workbook_xml)
        z.writestr('xl/_rels/workbook.xml.rels', wb_rels)
        z.writestr('xl/worksheets/sheet1.xml', sheet_xml)


def write_xlsx_records(path: str, records: List[Dict[str, Any]],
                       columns: Optional[List[str]] = None,
                       sheet: str = 'Sheet1') -> None:
    cols = columns or (list(records[0].keys()) if records else [])
    rows = [list(cols)] + [[rec.get(c) for c in cols] for rec in records]
    write_xlsx(path, rows, sheet)
