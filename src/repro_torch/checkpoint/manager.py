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
    another device than it saved from.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten_like


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically persist a tree of tensors and scalars.  Returns the
    final directory."""
    final = _step_dir(ckpt_dir, step)
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
    return final


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree):
    """``(tree, manifest)``: the checkpoint of `step` in the structure of
    `like_tree`, each tensor on the device and in the dtype of the leaf it
    replaces.  Raises KeyError naming a leaf the checkpoint lacks."""
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
    return unflatten_like(flat, like_tree), manifest


def retain(ckpt_dir: str, keep: int = 3) -> None:
    """Delete old checkpoints, keeping the newest ``keep``."""
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
