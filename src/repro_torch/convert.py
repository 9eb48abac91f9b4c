"""Carry parameters from the JAX package into the port.

`params_from_jax` takes the tree that ``repro``'s ``Network.init`` returns,
as numpy arrays (``np.asarray`` of each leaf), and gives the flat state dict
that the port's `Network` loads with ``load_state_dict``.  Layouts are kept
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
