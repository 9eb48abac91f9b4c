"""Nested parameter trees as flat name -> leaf dicts (the port's stand-in
for the part of ``jax.tree_util`` its trainer and checkpoints use).

A tree is nested dicts, lists and tuples with tensors or scalars at the
leaves, as `models.transformer.init_params` returns.  `flatten` names each
leaf by its path joined with dots (``"layers.3.attn.wq"``); `unflatten_like`
puts flat leaves back into the structure of a tree of the same shape, so a
name that holds dots itself (an optimizer moment keyed by a flat name) is
never split.
"""
from __future__ import annotations

from typing import Any, Mapping


def _join(prefix: str, key) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` in the tree's order (dict insertion order, list
    index order)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, value in items:
        out.update(flatten(value, _join(prefix, key)))
    return out


def unflatten_like(flat: Mapping[str, Any], like, prefix: str = ""):
    """The structure of `like` with each leaf taken from `flat` by its
    path; KeyError names a path that `flat` lacks."""
    if isinstance(like, Mapping):
        return {k: unflatten_like(flat, v, _join(prefix, k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten_like(flat, v, _join(prefix, i))
                          for i, v in enumerate(like))
    return flat[prefix]
