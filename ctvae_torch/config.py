"""Reading a config without PyYAML.

The card's machine has no PyYAML, and the entry points, the bench, the
search and the smoke run read ``configs/*.yaml`` and ``configs_hyp/*.yaml``
there. ``read_config`` reads the subset of YAML those files use, as
PyYAML's ``full_load`` reads it:

* block mappings, nested by indentation, and block sequences (``- item``
  lines under their key, at its indentation or deeper, as
  ``yaml.safe_dump`` writes them) of scalars;
* flow mappings (``{key: value, ...}``) and flow sequences (``[a, b]``),
  nested, which may run on over the lines below;
* scalars: quoted strings, null, booleans, ints, floats (YAML 1.1's
  floats: a dot is needed), other plain strings; ``!!python/tuple [lo,
  hi]`` is a tuple.

Anything else (a sequence of mappings, anchors, block scalars, other
tags, a top-level value that is no mapping) raises ``ValueError``.
``read_section`` reads one top-level section whose values are scalars and
lists of scalars (the model, data and trainer sections the bench and the
smoke read), and raises on a nested mapping there.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_TUPLE_TAG = "!!python/tuple"


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


def _depth(text: str) -> int:
    """Open brackets and braces of ``text`` outside quotes."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        else:
            depth += (ch in "[{") - (ch in "]}")
    return depth


def _lines(path: str) -> List[Tuple[int, str]]:
    """(indentation, text) of each logical line: comments and blank lines
    dropped, a flow collection's continuation lines joined to its first."""
    with open(path) as f:
        raw = [_strip_comment(ln.rstrip("\n")) for ln in f]
    out: List[Tuple[int, str]] = []
    pending = None
    for ln in raw:
        if not ln.strip():
            continue
        if ln.strip() in ("---", "...") or "\t" in ln[:len(ln)
                                                   - len(ln.lstrip())]:
            raise ValueError(f"{path}: not read: {ln!r}")
        if pending is not None:
            pending = (pending[0], pending[1] + " " + ln.strip())
        else:
            pending = (len(ln) - len(ln.lstrip()), ln.strip())
        if _depth(pending[1]) <= 0:
            out.append(pending)
            pending = None
    if pending is not None:
        raise ValueError(f"{path}: an unclosed bracket in {pending[1]!r}")
    return out


def _split(text: str) -> List[str]:
    """``text`` cut at its commas outside brackets, braces and quotes."""
    out, depth, start, quote = [], 0, 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        depth += (ch in "[{") - (ch in "]}")
        if ch == "," and depth == 0:
            out.append(text[start:i])
            start = i + 1
    return [s for s in out + [text[start:]] if s.strip()]


def _key_value(item: str) -> Tuple[str, str]:
    """(key, value text) of ``key: value`` (a plain or quoted key)."""
    m = re.match(r"\s*('[^']*'|\"[^\"]*\"|[^'\"\[\]{},:#&*!|>][^:]*?)"
                 r"\s*:(\s+(.*))?$", item)
    if m is None:
        raise ValueError(f"not a key: value pair: {item!r}")
    key = m.group(1)
    if key[0] in "'\"":
        key = key[1:-1]
    return key, (m.group(3) or "").strip()


def _scalar(t: str) -> Any:
    """A plain or quoted scalar as PyYAML resolves it."""
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t[:1] in ("&", "*", "!", "|", ">", "@", "`", "%"):
        raise ValueError(f"not read: {t!r}")
    if t in ("null", "Null", "NULL", "~", ""):
        return None
    if t.lower() in ("true", "false", "yes", "no", "on", "off") and (
            t in (t.lower(), t.upper(), t.capitalize())):
        return t.lower() in ("true", "yes", "on")
    if re.fullmatch(r"[-+]?\.(inf|Inf|INF)", t):
        return float(t.replace(".", ""))
    if t in (".nan", ".NaN", ".NAN"):
        return float("nan")
    if re.fullmatch(r"[-+]?(0|[1-9][0-9]*)", t):
        return int(t)
    if re.fullmatch(r"[-+]?([0-9][0-9_]*)?\.[0-9.]*([eE][-+][0-9]+)?", t) \
            and re.search(r"[0-9]", t):
        return float(t.replace("_", ""))
    return t


def _value(text: str) -> Any:
    """A value on one logical line: a flow collection, a tagged tuple or
    a scalar."""
    t = text.strip()
    if t.startswith(_TUPLE_TAG):
        inner = _value(t[len(_TUPLE_TAG):])
        if not isinstance(inner, list):
            raise ValueError(f"{_TUPLE_TAG} needs a flow sequence: {t!r}")
        return tuple(inner)
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"not read: {t!r}")
        return [_value(i) for i in _split(t[1:-1])]
    if t.startswith("{"):
        if not t.endswith("}"):
            raise ValueError(f"not read: {t!r}")
        out = {}
        for item in _split(t[1:-1]):
            key, value = _key_value(item)
            out[key] = _value(value)
        return out
    return _scalar(t)


def _block(lines: List[Tuple[int, str]], i: int, indent: int
           ) -> Tuple[Any, int]:
    """The block collection whose lines start at ``lines[i]``, at
    ``indent``; returns (its value, the index after it)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        items = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            item = lines[i][1][1:].strip()
            if re.match(r"[^'\"\[{]*:(\s|$)", item) or not item:
                raise ValueError(f"a sequence item is not read here: "
                                 f"{lines[i][1]!r}")
            items.append(_value(item))
            i += 1
        return items, i
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _key_value(lines[i][1])
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("- "))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"not read (indentation): {lines[i][1]!r}")
    return out, i


def read_config(path: str) -> Dict[str, Any]:
    """Every top-level section of the config at ``path``, by name, as
    ``yaml.full_load`` reads the file (see the module doc for what is
    read; anything else raises)."""
    lines = _lines(path)
    if not lines:
        return {}
    if lines[0][0] != 0:
        raise ValueError(f"{path}: the first line is indented")
    try:
        out, i = _block(lines, 0, 0)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if i != len(lines) or not isinstance(out, dict):
        raise ValueError(f"{path}: no section opens at {lines[i][1]!r}"
                         if i < len(lines) else f"{path}: not a mapping")
    for name, body in out.items():
        if not isinstance(body, dict):
            raise ValueError(f"{path}: {name} is not a mapping")
    return out


def read_section(path: str, name: str) -> Dict[str, Any]:
    """The mapping of top-level section ``name`` of the config at
    ``path``: scalars and lists of scalars only (a nested mapping
    raises)."""
    lines = _lines(path)
    config, _ = _block(lines, 0, 0) if lines else ({}, 0)
    if name not in config:
        raise ValueError(f"{path}: no {name} section")
    section = config[name]
    if not isinstance(section, dict):
        raise ValueError(f"{path}: {name} is not a mapping")
    for key, value in section.items():
        if isinstance(value, dict) or (isinstance(value, (list, tuple)) and
                                       any(isinstance(v, (dict, list, tuple))
                                           for v in value)):
            raise ValueError(f"{path}: a nested mapping is not read: "
                             f"{name}.{key}")
    return section
