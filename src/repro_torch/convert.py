"""Carry parameters between the JAX package and the port.

`params_from_jax` takes the tree that ``repro``'s ``Network.init`` returns,
as numpy arrays (``np.asarray`` of each leaf), and gives the flat state dict
that the port's `Network` loads with ``load_state_dict``; `params_to_numpy`
is its inverse, for holding trained parameters and optimizer moments
against the JAX trees.  Layouts are kept
as they are: conv weights flattened HWIO ``(kh*kw*Cin, Cout)``, deconv
weights ``(Cin, kh*kw*Cout)``, connected weights ``(nin, nout)`` with the
input flattened in (h, w, c) order, and the per-channel vectors.

`lm_params_from_jax` does the same for the tree of ``repro``'s
``models.transformer.init_params`` (dense GQA stacks): the JAX tree keeps
each layer-program entry's layers stacked under a leading layer axis
(``stacks[0]["attn"]["wq"]`` is (n_layers, D, H*hd)); the port keeps one
dict per layer (``layers[i]["attn"]["wq"]``, (D, H*hd)).  Every other
layout is kept.  `lm_params_to_numpy` is its inverse.
`opt_state_from_jax` / `opt_state_to_numpy` carry the JAX AdamW state
(``{"mu": tree, "nu": tree, "step"}``) to and from the port's (moments
keyed by the flat parameter names of `repro_torch.tree.flatten`), so a
JAX step and a port step start from the same (params, moments).  This
module reads numpy only; it imports no jax.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten_like


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


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_jax(tree: Mapping, cfg, device=None) -> dict:
    """The JAX LM tree (numpy-convertible leaves) -> the port's parameter
    dict (`repro_torch.models.transformer`), fp32 tensors on `device`, with
    the stacked layers unstacked."""
    from repro_torch.models import transformer as tfm
    (_, n), = tfm.stack_program(cfg)
    (stack,) = tree["stacks"]

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    params = {key: _tree_map(tensor, tree[key])
              for key in ("embed", "final_norm", "lm_head") if key in tree}
    params["layers"] = [_tree_map(lambda a, i=i: tensor(np.asarray(a)[i]),
                                  stack) for i in range(n)]
    return params


def lm_params_to_numpy(params: Mapping) -> dict:
    """Inverse of `lm_params_from_jax`: the JAX tree layout (layers stacked
    under ``stacks[0]``) as fp32 numpy arrays."""
    def array(t):
        return t.detach().float().cpu().numpy()

    tree = {key: _tree_map(array, params[key])
            for key in ("embed", "final_norm", "lm_head") if key in params}
    layers = [_tree_map(array, lp) for lp in params["layers"]]

    def stack(*leaves):
        return np.stack(leaves)

    def stack_tree(trees):
        first = trees[0]
        if isinstance(first, Mapping):
            return {k: stack_tree([t[k] for t in trees]) for k in first}
        return stack(*trees)

    tree["stacks"] = [stack_tree(layers)]
    return tree


def opt_state_from_jax(state: Mapping, cfg, device=None) -> dict:
    """The JAX LM AdamW state ``{"mu", "nu": tree, "step"}`` (numpy
    leaves) -> the port's ``{"mu", "nu": {flat name: tensor}, "step":
    int}`` (`train.optimizer.adamw_init` over ``tree.flatten(params)``)."""
    return {"mu": flatten(lm_params_from_jax(state["mu"], cfg, device)),
            "nu": flatten(lm_params_from_jax(state["nu"], cfg, device)),
            "step": int(np.asarray(state["step"]))}


def opt_state_to_numpy(state: Mapping, params: Mapping) -> dict:
    """Inverse of `opt_state_from_jax`: the moments in the JAX tree layout
    as fp32 numpy arrays and the step as an int32 scalar; `params` (the
    port's nested parameters) gives the nesting of the flat names."""
    return {key: lm_params_to_numpy(unflatten_like(state[key], params))
            for key in ("mu", "nu")} | {
        "step": np.asarray(state["step"], np.int32)}
