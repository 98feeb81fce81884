"""Reading a section of a config without PyYAML.

The card's machine has no PyYAML, and the bench and the smoke run read
their widths from ``configs/*.yaml`` there. ``read_section`` reads the
subset of YAML those files use: a top-level section written as a block
mapping (one ``key: value`` per indented line) or as a flow mapping
(``{key: value, ...}``, which may run on over indented lines), whose
values are scalars or flow lists of scalars. Anything else raises.
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
                body.append(ln.strip())
        if not rest:
            return dict(_pair(ln) for ln in body)
        flow = " ".join([rest] + body)
        if not (flow.startswith("{") and flow.endswith("}")):
            raise ValueError(f"{path}: {name} is not a mapping")
        return dict(_pair(item) for item in _split(flow[1:-1]))
    raise ValueError(f"{path}: no {name} section")
