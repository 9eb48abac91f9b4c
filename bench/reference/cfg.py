"""The benchmark's own reading of a Darknet ``.cfg``: sections, then a layer
table with every shape.

This is the yardstick's copy, independent of the program's parser: the
reference forward, the weight maker and the FLOP and byte arithmetic all
read the table built here.  It knows the sections the benchmark's
configurations use: net, convolutional, maxpool, avgpool, shortcut,
connected and softmax.
"""
from __future__ import annotations

import dataclasses

KNOWN = ("net", "convolutional", "maxpool", "avgpool", "shortcut",
         "connected", "softmax")


@dataclasses.dataclass(frozen=True)
class Layer:
    """One section after [net].  `index` counts from 0 at the first
    section after [net], as Darknet numbers its layers.  Shapes are
    (H, W, C) per image; a [connected] or pooled output is (1, 1, C)."""
    index: int
    type: str
    in_shape: tuple
    out_shape: tuple
    size: int = 0
    stride: int = 1
    pad: int = 0
    batch_normalize: bool = False
    activation: str = "linear"
    source: int = -1  # a [shortcut]'s other input, as an absolute index


def parse(text: str) -> list[tuple[str, dict]]:
    """Sections as (type, options) in file order; values are int, float or
    str.  Raises ValueError on a section the benchmark does not know or a
    line outside a section."""
    sections: list[tuple[str, dict]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            kind = line.strip("[] ").lower()
            if kind not in KNOWN:
                raise ValueError(f"section [{kind}] is not one the "
                                 f"benchmark knows")
            sections.append((kind, {}))
            continue
        if not sections or "=" not in line:
            raise ValueError(f"malformed cfg line {raw!r}")
        key, val = (s.strip() for s in line.split("=", 1))
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        sections[-1][1][key] = val
    if not sections or sections[0][0] != "net":
        raise ValueError("a cfg starts with [net]")
    return sections


def layers(text: str) -> list[Layer]:
    """The layer table of a cfg, with every input and output shape."""
    sections = parse(text)
    net = sections[0][1]
    shape = (net["height"], net["width"], net["channels"])
    out: list[Layer] = []
    for i, (kind, o) in enumerate(sections[1:]):
        h, w, c = shape
        if kind == "convolutional":
            k, s = o.get("size", 1), o.get("stride", 1)
            pad = k // 2 if o.get("pad", 0) else o.get("padding", 0)
            nxt = ((h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1,
                   o["filters"])
            lay = Layer(i, kind, shape, nxt, size=k, stride=s, pad=pad,
                        batch_normalize=bool(o.get("batch_normalize", 0)),
                        activation=o.get("activation", "logistic"))
        elif kind == "maxpool":
            k, s = o.get("size", 2), o.get("stride", 2)
            nxt = ((h - k) // s + 1, (w - k) // s + 1, c)
            lay = Layer(i, kind, shape, nxt, size=k, stride=s)
        elif kind == "avgpool":
            lay = Layer(i, kind, shape, (1, 1, c))
        elif kind == "shortcut":
            src = o["from"] + i if o["from"] < 0 else o["from"]
            if out[src].out_shape != shape:
                raise ValueError(f"shortcut {i} adds {out[src].out_shape} "
                                 f"to {shape}")
            lay = Layer(i, kind, shape, shape, source=src,
                        activation=o.get("activation", "linear"))
        elif kind == "connected":
            lay = Layer(i, kind, shape, (1, 1, o["output"]),
                        activation=o.get("activation", "logistic"))
        else:  # softmax
            lay = Layer(i, kind, shape, shape)
        out.append(lay)
        shape = lay.out_shape
    return out


def weighted(table: list[Layer]) -> list[Layer]:
    """The layers that hold weights: convolutional and connected."""
    return [lay for lay in table if lay.type in ("convolutional",
                                                 "connected")]


def param_shapes(lay: Layer) -> dict[str, tuple]:
    """The raw parameters of a weighted layer, in the layout both sides
    take: ``w`` is (k*k*Cin, Cout), rows in (kh, kw, Cin) order (a
    [connected] layer's rows are its flattened (H, W, C) input); then
    BN's gamma, beta, mean and var, or a bias ``b``."""
    h, w, c = lay.in_shape
    cout = lay.out_shape[2]
    rows = lay.size * lay.size * c if lay.type == "convolutional" \
        else h * w * c
    shapes = {"w": (rows, cout)}
    if lay.batch_normalize:
        shapes.update(gamma=(cout,), beta=(cout,), mean=(cout,), var=(cout,))
    else:
        shapes["b"] = (cout,)
    return shapes
