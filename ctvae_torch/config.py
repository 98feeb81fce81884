"""Reading a config without PyYAML.

The card's machine has no PyYAML, and the entry points, the bench and the
smoke run read ``configs/*.yaml`` there. ``read_section`` reads the
subset of YAML those files use: a top-level section written as a block
mapping (one ``key: value`` per indented line) or as a flow mapping
(``{key: value, ...}``, which may run on over indented lines), whose
values are scalars or lists of scalars (flow lists, or in a block
mapping ``- item`` lines under their key, as ``yaml.safe_dump`` writes
them); ``read_config`` reads every top-level section of a file so.
Anything else raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List


def _split(text: str) -> List[str]:
    """``text`` cut at its commas outside brackets and braces."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        depth += (ch in "[{") - (ch in "]}")
        if ch == "," and depth == 0:
            out.append(text[start:i])
            start = i + 1
    return [s for s in out + [text[start:]] if s.strip()]


def _value(text: str) -> Any:
    """A scalar or a flow list of scalars, as PyYAML's ``safe_load``
    reads the ones the repo's configs use."""
    t = text.strip()
    if t.startswith("[") and t.endswith("]"):
        return [_value(i) for i in _split(t[1:-1])]
    if t.startswith("{"):
        raise ValueError(f"a nested mapping is not read: {t!r}")
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t in ("null", "~", ""):
        return None
    if t in ("true", "True", "false", "False"):
        return t in ("true", "True")
    if re.fullmatch(r"[-+]?[0-9]+", t):
        return int(t)
    if re.fullmatch(r"[-+]?[0-9]*\.[0-9]*([eE][-+][0-9]+)?", t):
        return float(t)
    return t


def _pair(item: str) -> tuple:
    key, value = item.split(":", 1)
    return key.strip(), _value(value)


def _block(lines: List[str]) -> Dict[str, Any]:
    """A block mapping's ``key: value`` lines, all at the first one's
    indentation; ``- item`` lines (at it or deeper) append to the list of
    the key above them, which has no value of its own."""
    out: Dict[str, Any] = {}
    key = None
    indent = len(lines[0]) - len(lines[0].lstrip()) if lines else 0
    for raw in lines:
        ln, depth = raw.strip(), len(raw) - len(raw.lstrip())
        if ln == "-" or ln.startswith("- "):
            item = ln[1:].strip()
            if key is None or not isinstance(out[key], (list, type(None))) \
                    or re.match(r"[^'\"\[]*:(\s|$)", item):
                raise ValueError(f"a sequence item is not read here: {ln!r}")
            out[key] = (out[key] or []) + [_value(item)]
        elif depth != indent:
            raise ValueError(f"a nested mapping is not read: {raw!r}")
        else:
            key, value = _pair(ln)
            out[key] = value
    return out


def read_section(path: str, name: str) -> Dict[str, Any]:
    """The mapping of top-level section ``name`` of the config at
    ``path`` (see the module doc for what is read)."""
    with open(path) as f:
        lines = [ln.split(" #")[0].rstrip() for ln in f
                 if not ln.lstrip().startswith("#")]
    for i, line in enumerate(lines):
        if not line.startswith(f"{name}:"):
            continue
        body, rest = [], line.split(":", 1)[1].strip()
        for ln in lines[i + 1:]:
            if ln and not ln[0].isspace():
                break
            if ln.strip():
                body.append(ln)
        if not rest:
            return _block(body)
        flow = " ".join([rest] + [ln.strip() for ln in body])
        if not (flow.startswith("{") and flow.endswith("}")):
            raise ValueError(f"{path}: {name} is not a mapping")
        return dict(_pair(item) for item in _split(flow[1:-1]))
    raise ValueError(f"{path}: no {name} section")


def read_config(path: str) -> Dict[str, Dict[str, Any]]:
    """Every top-level section of the config at ``path``, by name, as
    ``yaml.safe_load`` reads the file (see the module doc for what is
    read; a top-level line that opens no section raises)."""
    with open(path) as f:
        tops = [ln.split(" #")[0].rstrip() for ln in f
                if ln.strip() and not ln[0].isspace()
                and not ln.startswith("#")]
    names = []
    for line in tops:
        m = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_]*):(\s.*)?", line)
        if m is None:
            raise ValueError(f"{path}: no section opens at {line!r}")
        names.append(m.group(1))
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: a section appears twice: {names}")
    return {name: read_section(path, name) for name in names}
