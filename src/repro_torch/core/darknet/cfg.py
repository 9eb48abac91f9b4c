"""Darknet ``.cfg`` parser.

The paper's front end: "allows the designer, by using a similar input to that
given to Darknet, to efficiently implement a CNN".  This parses the standard
Darknet INI-ish format into typed layer specs.

Supported sections: net, convolutional, deconvolutional, maxpool, avgpool,
upsample, route, shortcut, connected, softmax, dropout (inference no-op).
"""
from __future__ import annotations

import dataclasses
from typing import Any

_INT_KEYS = {"batch", "height", "width", "channels", "filters", "size",
             "stride", "pad", "padding", "groups", "batch_normalize",
             "output", "from", "reverse", "flatten"}
_FLOAT_KEYS = {"momentum", "decay", "learning_rate", "probability", "scale"}
_LIST_KEYS = {"layers"}

SECTION_TYPES = ("net", "convolutional", "deconvolutional", "maxpool",
                 "avgpool", "upsample", "route", "shortcut", "connected",
                 "softmax", "dropout")


@dataclasses.dataclass
class Section:
    type: str
    options: dict[str, Any]

    def get(self, key, default=None):
        return self.options.get(key, default)


def _coerce(key: str, val: str):
    val = val.strip()
    if key in _LIST_KEYS:
        return [int(v) for v in val.split(",") if v.strip()]
    if key in _INT_KEYS:
        return int(val)
    if key in _FLOAT_KEYS:
        return float(val)
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val)
    except ValueError:
        return val


def conv_pad(options: dict[str, Any] | Section, size: int) -> int:
    """Darknet conv/deconv padding rule, in one place.

    ``pad=1`` means "same-ish": use size // 2 (even for size == 1, where
    that is 0); otherwise an explicit ``padding=N`` wins, defaulting to 0.
    """
    get = options.get
    if get("pad", 0):
        return size // 2
    return get("padding", 0)


def parse_cfg(text: str) -> list[Section]:
    sections: list[Section] = []
    current: Section | None = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].split(";", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            name = line.strip("[] \t").lower()
            if name not in SECTION_TYPES:
                raise ValueError(f"unsupported darknet section [{name}]")
            current = Section(type=name, options={})
            sections.append(current)
            continue
        if current is None or "=" not in line:
            raise ValueError(f"malformed cfg line: {raw!r}")
        key, val = line.split("=", 1)
        current.options[key.strip()] = _coerce(key.strip(), val)
    if not sections or sections[0].type != "net":
        raise ValueError("cfg must start with a [net] section")
    return sections


def dump_cfg(sections: list[Section]) -> str:
    """Round-trip serializer (property-tested against parse_cfg)."""
    out = []
    for s in sections:
        out.append(f"[{s.type}]")
        for k, v in s.options.items():
            if isinstance(v, list):
                v = ",".join(str(i) for i in v)
            out.append(f"{k}={v}")
        out.append("")
    return "\n".join(out)
