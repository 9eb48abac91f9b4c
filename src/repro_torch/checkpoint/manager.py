"""Checkpointing: an npz file plus a JSON manifest, atomic (PyTorch port of
``repro/checkpoint/manager.py``).

Fault-tolerance contract (launch/train.py):
  * atomic: written to ``step_N.tmp/`` then renamed, so a crash mid-write
    never corrupts the latest checkpoint;
  * self-describing: manifest.json carries the step, the flat leaf names
    (`repro_torch.tree.flatten`: ``"0.layers.3.attn.wq"``), the scalar
    leaves (an optimizer's step count) and the caller's extras, so restore
    works in a fresh process;
  * device-free: tensors are saved from the host as fp32 numpy arrays
    keyed by their flat names, and `restore` puts each back on the device
    and in the dtype of the tree it restores into, so a run restores onto
    another device than it saved from;
  * elastic (JAX's contract): a ZeRO-1 optimizer state
    (`optimizer.zero1_init`, each rank holding blocks of the moments) is
    saved whole: every rank gathers its moments (`optimizer.gather_moments`)
    and rank 0 writes, so a checkpoint is the same file whichever layout
    wrote it; `restore(..., shardings=...)` cuts the whole moments back
    into this rank's blocks of any ZeRO-1 layout, or keeps them whole for
    a replicated run.
"""
from __future__ import annotations

import json
import os
import shutil

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten_like


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _is_zero1(node) -> bool:
    return isinstance(node, Mapping) and "zero1" in node and "mu" in node


def _whole(tree):
    """`tree` with every ZeRO-1 optimizer state replaced by its whole
    moments (a collective: every rank of the state's mesh calls it)."""
    if _is_zero1(tree):
        from repro_torch.train import optimizer
        return optimizer.gather_moments(tree)
    if isinstance(tree, Mapping):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return tree


def _holds_zero1(tree) -> bool:
    if _is_zero1(tree):
        return True
    if isinstance(tree, Mapping):
        return any(_holds_zero1(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_zero1(v) for v in tree)
    return False


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically persist a tree of tensors and scalars.  Returns the
    final directory.

    A tree holding a ZeRO-1 state is saved with its moments whole: every
    rank must call `save` (the moments are gathered), rank 0 writes, and
    every rank returns after the write (a barrier of the default group)."""
    final = _step_dir(ckpt_dir, step)
    if _holds_zero1(tree):
        tree = _whole(tree)
        if dist.is_initialized():
            if dist.get_rank() == 0:
                _write(final, step, tree, extra)
            dist.barrier()
            return final
    _write(final, step, tree, extra)
    return final


def _write(final: str, step: int, tree, extra: dict | None) -> None:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = flatten(tree)
    arrays = {k: v.detach().float().cpu().numpy() for k, v in flat.items()
              if isinstance(v, torch.Tensor)}
    scalars = {k: v for k, v in flat.items()
               if not isinstance(v, torch.Tensor)}
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    manifest = {"step": step, "names": list(arrays), "scalars": scalars,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *, shardings=None):
    """``(tree, manifest)``: the checkpoint of `step` in the structure of
    `like_tree`, each tensor on the device and in the dtype of the leaf it
    replaces.  Raises KeyError naming a leaf the checkpoint lacks.

    `shardings` is JAX's elastic restore onto another mesh: a tree with
    `like_tree`'s structure down to its optimizer states, None where a
    subtree stays as restored and a ZeRO-1 state (`optimizer.zero1_init`
    on this rank's mesh) where the whole moments restored there (in
    `like_tree`'s replicated layout, ``{"mu", "nu": {flat name: tensor},
    "step"}``) become this rank's blocks of that layout
    (`optimizer.zero1_shard`).  No collective runs."""
    final = _step_dir(ckpt_dir, step)
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    like = flatten(like_tree)
    with np.load(os.path.join(final, "shard_0.npz")) as data:
        flat = {}
        for name, leaf in like.items():
            if isinstance(leaf, torch.Tensor):
                flat[name] = torch.from_numpy(data[name]).to(
                    device=leaf.device, dtype=leaf.dtype)
            else:
                flat[name] = type(leaf)(manifest["scalars"][name])
    tree = unflatten_like(flat, like_tree)
    if shardings is not None:
        tree = _shard(tree, shardings)
    return tree, manifest


def _shard(tree, shardings):
    if shardings is None:
        return tree
    if _is_zero1(shardings):
        from repro_torch.train import optimizer
        return optimizer.zero1_shard(tree, shardings)
    if isinstance(tree, Mapping):
        return {k: _shard(v, shardings.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shard(v, s) for v, s in zip(tree, shardings))
    return tree


def retain(ckpt_dir: str, keep: int = 3) -> None:
    """Delete old checkpoints, keeping the newest ``keep``."""
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
