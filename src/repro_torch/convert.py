"""Carry parameters between the JAX package and the port.

`params_from_jax` takes the tree that ``repro``'s ``Network.init`` returns,
as numpy arrays (``np.asarray`` of each leaf), and gives the flat state dict
that the port's `Network` loads with ``load_state_dict``; `params_to_numpy`
is its inverse, for holding trained parameters and optimizer moments
against the JAX trees.  Layouts are kept
as they are: conv weights flattened HWIO ``(kh*kw*Cin, Cout)``, deconv
weights ``(Cin, kh*kw*Cout)``, connected weights ``(nin, nout)`` with the
input flattened in (h, w, c) order, and the per-channel vectors.  This
module reads numpy only; it imports no jax.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Mapping]) -> dict[str, torch.Tensor]:
    """``{"l0": {"w": array, "gamma": array, ...}, ...}`` ->
    ``{"l0.w": tensor, "l0.gamma": tensor, ...}`` (fp32 CPU tensors that
    own their memory)."""
    return {f"{layer}.{name}": torch.tensor(np.asarray(value, np.float32))
            for layer, leaves in tree.items()
            for name, value in leaves.items()}


def params_to_numpy(state_dict: Mapping[str, torch.Tensor]
                    ) -> dict[str, dict[str, np.ndarray]]:
    """``{"l0.w": tensor, ...}`` (a state dict, or a dict of named
    parameters or moments) -> ``{"l0": {"w": array, ...}, ...}``, fp32
    numpy arrays on the host."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        layer, name = key.split(".", 1)
        tree.setdefault(layer, {})[name] = (
            value.detach().float().cpu().numpy())
    return tree
