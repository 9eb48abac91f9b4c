"""Raw parameters drawn from the seed on the card, in two large calls.

Both sides get the same tensors: the program's `Network` has them copied
into its parameters, the reference folds batch norm from them itself.
The draw is set by the configuration's ``weights`` block:

- ``w``: He-normal, std sqrt(2 / fan_in), every weighted layer;
- batch norm: gamma, beta, mean and var uniform in their ranges, so the
  fold is not the identity; a convolution whose output a [shortcut] adds
  takes ``gamma_into_shortcut``, so the residual stream stays at scale;
- ``b`` of a layer without batch norm: uniform in its range.
"""
from __future__ import annotations

import math

import torch

from harness import seeds
from reference.cfg import Layer, param_shapes, weighted

VECTORS = ("gamma", "beta", "mean", "var", "b")


def _into_shortcut(table: list[Layer]) -> set[int]:
    return {lay.index - 1 for lay in table if lay.type == "shortcut"}


def make(table: list[Layer], spec: dict, seed: int,
         device: torch.device) -> dict[str, dict[str, torch.Tensor]]:
    """``{"l{index}": {name: fp32 tensor on device}}`` for every weighted
    layer, a pure function of (table, spec, seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "weights"))
    layers = weighted(table)
    shapes = [param_shapes(lay) for lay in layers]
    n_w = sum(math.prod(s["w"]) for s in shapes)
    n_v = sum(math.prod(v) for s in shapes for k, v in s.items() if k != "w")
    normal = torch.randn(n_w, generator=gen, device=device)
    uniform = torch.rand(n_v, generator=gen, device=device)
    into = _into_shortcut(table)
    out: dict[str, dict[str, torch.Tensor]] = {}
    iw = iv = 0
    for lay, shp in zip(layers, shapes):
        rows, cols = shp["w"]
        p = {"w": (normal[iw:iw + rows * cols].view(rows, cols)
                   * math.sqrt(2.0 / rows))}
        iw += rows * cols
        for name in VECTORS:
            if name not in shp:
                continue
            n = shp[name][0]
            key = "gamma_into_shortcut" if (
                name == "gamma" and lay.index in into) else name
            lo, hi = spec[key]
            p[name] = lo + (hi - lo) * uniform[iv:iv + n]
            iv += n
        out[f"l{lay.index}"] = p
    return out
