"""Config system: per-entry-point YAML with composition and dotted CLI overrides.

The port of octseg/core/config.py. Same semantics — ``configs/<name>.yaml``
per entry point, ``defaults: [main, _self_]`` composition (later wins),
``key=value`` / ``a.b.c=value`` overrides parsed as YAML values, attribute
access — but with its own reader for the YAML subset the repo's configs use,
since PyYAML is not part of the port's runtime:

- block mappings (``key: value``, ``key:`` + an indented block);
- block lists (``- scalar``, ``- [flow, list]``) under a key;
- flow lists (``[a, 'b c', [1, 2]]``), nested;
- plain, single- and double-quoted scalars, resolved as YAML 1.1 (PyYAML's
  ``safe_load``) resolves them: null, bool, int, float, else str;
- ``#`` comments.

Anything else (anchors, flow mappings, multi-line scalars, lists of
mappings, tags, ...) raises :class:`YamlSubsetError` naming the line.
"""

from __future__ import annotations

import copy
import functools
import logging
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

import octseg_torch


class YamlSubsetError(ValueError):
    """Input outside the YAML subset this reader supports."""


_NULLS = {'', '~', 'null', 'Null', 'NULL'}
_TRUE = {'yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON'}
_FALSE = {'no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off', 'OFF'}
_INT = re.compile(r'[-+]?(?:0|[1-9][0-9_]*)$')
# other YAML 1.1 int spellings (binary, octal, hex, sexagesimal) and
# timestamps: PyYAML gives them non-str types this reader does not build
_UNSUPPORTED = re.compile(
    r'[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$'
    r'|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$'
    r'|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}')
_FLOAT = re.compile(
    r'[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$'
    r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$')
_INF = re.compile(r'([-+]?)\.(?:inf|Inf|INF)$')
_NAN = re.compile(r'\.(?:nan|NaN|NAN)$')
_INDICATORS = set('&*!|>%@`{}')


def _resolve_plain(tok: str) -> Any:
    """YAML 1.1 implicit typing of a plain scalar (PyYAML resolver rules)."""
    if tok in _NULLS:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace('_', ''))
    if _FLOAT.match(tok):
        return float(tok.replace('_', ''))
    m = _INF.match(tok)
    if m:
        return float(m.group(1) + 'inf')
    if _NAN.match(tok):
        return float('nan')
    if _UNSUPPORTED.match(tok) or tok[0] in _INDICATORS:
        raise YamlSubsetError(f'unsupported YAML scalar {tok!r}')
    return tok


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace), outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            if i == 0 or line[i - 1] in ' \t[,:-':
                quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


def _parse_quoted(s: str, i: int) -> Tuple[str, int]:
    q = s[i]
    out = []
    i += 1
    while i < len(s):
        ch = s[i]
        if q == "'" and ch == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return ''.join(out), i + 1
        if q == '"' and ch == '\\':
            esc = s[i + 1:i + 2]
            table = {'n': '\n', 't': '\t', '\\': '\\', '"': '"', '/': '/',
                     '0': '\0', 'r': '\r'}
            if esc not in table:
                raise YamlSubsetError(f'unsupported escape \\{esc} in {s!r}')
            out.append(table[esc])
            i += 2
            continue
        if q == '"' and ch == '"':
            return ''.join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlSubsetError(f'unterminated quoted scalar in {s!r}')


def _parse_flow(s: str, i: int) -> Tuple[Any, int]:
    """Parse one flow value starting at s[i] (list, quoted or plain)."""
    while i < len(s) and s[i] == ' ':
        i += 1
    if i < len(s) and s[i] == '[':
        items: List[Any] = []
        i += 1
        while True:
            while i < len(s) and s[i] == ' ':
                i += 1
            if i >= len(s):
                raise YamlSubsetError(f'unterminated flow list in {s!r}')
            if s[i] == ']':
                return items, i + 1
            value, i = _parse_flow(s, i)
            items.append(value)
            while i < len(s) and s[i] == ' ':
                i += 1
            if i < len(s) and s[i] == ',':
                i += 1
            elif i < len(s) and s[i] == ']':
                continue
            else:
                raise YamlSubsetError(f'expected , or ] in {s!r}')
    if i < len(s) and s[i] in '\'"':
        return _parse_quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ',]':
        j += 1
    tok = s[i:j].strip()
    if tok == '':
        raise YamlSubsetError(f'empty flow item in {s!r}')
    return _resolve_plain(tok), j


def parse_value(s: str) -> Any:
    """A complete inline value: flow list, quoted scalar or plain scalar."""
    s = s.strip()
    if not s:
        return None
    if s[0] in '[\'"':
        value, end = _parse_flow(s, 0)
        if s[end:].strip():
            raise YamlSubsetError(f'trailing characters after value: {s!r}')
        return value
    if ': ' in s or s.endswith(':') or s.startswith('- '):
        raise YamlSubsetError(f'unsupported inline structure {s!r}')
    return _resolve_plain(s)


def _split_key(text: str, lineno: int) -> Tuple[str, str]:
    m = re.match(r'([A-Za-z0-9_][A-Za-z0-9_.\- ]*?)\s*:(?:\s+(.*))?$', text)
    if not m:
        raise YamlSubsetError(f'line {lineno}: expected "key: value", got {text!r}')
    return m.group(1), (m.group(2) or '')


def load_yaml(text: str) -> Any:
    """Parse a document of the supported YAML subset (see module docstring)."""
    lines: List[Tuple[int, int, str]] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if '\t' in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f'line {lineno}: tab indentation')
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ('---', '...'):
            raise YamlSubsetError(f'line {lineno}: multi-document streams')
        indent = len(body) - len(body.lstrip(' '))
        lines.append((indent, lineno, body.strip()))
    if not lines:
        return None
    value, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f'line {lines[pos][1]}: unexpected indentation')
    return value


def _parse_block(lines, pos: int, indent: int) -> Tuple[Any, int]:
    if lines[pos][2].startswith('- ') or lines[pos][2] == '-':
        return _parse_list(lines, pos, indent)
    return _parse_map(lines, pos, indent)


def _parse_list(lines, pos: int, indent: int) -> Tuple[List[Any], int]:
    out: List[Any] = []
    while pos < len(lines) and lines[pos][0] == indent:
        _ind, lineno, text = lines[pos]
        if not (text.startswith('- ') or text == '-'):
            break
        item = text[1:].strip()
        if item.startswith('- ') or re.match(r'[^\'"\[]*:(\s|$)', item):
            raise YamlSubsetError(f'line {lineno}: nested block in a list item')
        out.append(parse_value(item))
        pos += 1
    return out, pos


def _parse_map(lines, pos: int, indent: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while pos < len(lines) and lines[pos][0] == indent:
        _ind, lineno, text = lines[pos]
        if text.startswith('- ') or text == '-':
            raise YamlSubsetError(f'line {lineno}: list item inside a mapping')
        key, rest = _split_key(text, lineno)
        pos += 1
        if key in out:
            raise YamlSubsetError(f'line {lineno}: duplicate key {key!r}')
        key = _resolve_key(key, lineno)
        if rest:
            out[key] = parse_value(rest)
            continue
        if pos < len(lines):
            nxt_indent, _, nxt = lines[pos]
            is_item = nxt.startswith('- ') or nxt == '-'
            if nxt_indent > indent or (nxt_indent == indent and is_item):
                out[key], pos = _parse_block(lines, pos, nxt_indent)
                continue
        out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise YamlSubsetError(f'line {lines[pos][1]}: unexpected indentation')
    return out, pos


def _resolve_key(key: str, lineno: int) -> str:
    value = _resolve_plain(key)
    if not isinstance(value, str):
        raise YamlSubsetError(f'line {lineno}: non-string key {key!r}')
    return value


class Config(dict):
    """Dict with attribute access and recursive wrapping (DictConfig-alike)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getitem__(self, key: str) -> Any:
        value = super().__getitem__(key)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            super().__setitem__(key, value)
        return value

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k in self:
            v = self[k]
            out[k] = v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_composed(config_dir: str, name: str,
                        _stack: Optional[set] = None) -> Dict[str, Any]:
    _stack = _stack or set()
    if name in _stack:
        raise ValueError(f'Config composition cycle at {name!r}')
    with open(os.path.join(config_dir, f'{name}.yaml')) as f:
        raw = load_yaml(f.read()) or {}
    defaults: List[str] = raw.pop('defaults', [])
    merged: Dict[str, Any] = {}
    self_seen = False
    for d in defaults:
        if d == '_self_':
            merged = _deep_merge(merged, raw)
            self_seen = True
        else:
            merged = _deep_merge(
                merged, _load_yaml_composed(config_dir, d, _stack | {name}))
    if not self_seen:
        merged = _deep_merge(merged, raw)
    return merged


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split('.')
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _coerce_numbers(value: Any) -> Any:
    """YAML 1.1 reads '1e-5' as a string; overrides coerce numeric-looking
    strings to float, recursively through lists (as octseg does)."""
    if isinstance(value, list):
        return [_coerce_numbers(v) for v in value]
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def parse_overrides(argv: List[str]) -> Dict[str, Any]:
    """Parse ``key=value`` CLI overrides; values are typed as YAML values."""
    out: Dict[str, Any] = {}
    for arg in argv:
        if '=' not in arg:
            raise ValueError(f'Override {arg!r} is not of the form key=value')
        key, _, raw = arg.partition('=')
        key = key.lstrip('+')
        try:
            value = parse_value(raw)
        except YamlSubsetError:
            value = raw
        out[key] = _coerce_numbers(value)
    return out


def load_config(name: str, overrides: Optional[List[str]] = None,
                config_dir: Optional[str] = None) -> Config:
    config_dir = config_dir or os.path.join(octseg_torch.PROJECT_DIR, 'configs')
    merged = _load_yaml_composed(config_dir, name)
    for key, value in parse_overrides(overrides or []).items():
        _set_dotted(merged, key, value)
    return Config(merged)


def setup_logging() -> None:
    """Console logging to stderr in the reference's format. The port writes
    no log files: stdout stays free for results."""
    fmt = logging.Formatter('[%(asctime)s][%(levelname)s] - %(message)s',
                            datefmt='%d-%m-%Y %H:%M:%S')
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(fmt)
    root.addHandler(console)


def entry_point(config_name: str):
    """Decorator turning ``main(cfg)`` into a CLI entry point: called with no
    arguments it reads ``key=value`` overrides from ``sys.argv[1:]``; it can
    also be called with a prebuilt :class:`Config` (as the tests do)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(cfg: Optional[Config] = None,
                    overrides: Optional[List[str]] = None):
            if cfg is None:
                cfg = load_config(config_name, overrides=overrides or sys.argv[1:])
            setup_logging()
            return fn(cfg)

        wrapper.config_name = config_name
        return wrapper

    return decorator
