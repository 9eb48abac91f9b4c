"""Optimizers on dicts of named tensors (PyTorch port of
``repro/train/optimizer.py``).

AdamW with decoupled weight decay and global-norm clipping, and SGD with
momentum as the cheap baseline.  Parameters, gradients and moments are
dicts keyed by parameter name (``dict(net.named_parameters())``); moments
are fp32.  The JAX functions return new trees; these update the parameter
and moment tensors IN PLACE under ``torch.no_grad()`` (so an ``nn.Module``
keeps its own ``Parameter`` objects) and return the same dicts.

Kept from the JAX package: the step counter goes up before `schedule` is
read, and weight decay applies to every leaf, batch-norm vectors and
biases included.  ``torch.optim.AdamW`` is not used: it decays the weights
in another order and has no such schedule.

ZeRO-1 (the JAX package applies `sharding.policy.zero1_pspecs` to the
moments at the jit boundary): `zero1_init` builds a state in which each
rank of a mesh holds only its block of every moment, by the placements
`policy.named` gives the stacked leaf (the layers of a program entry
taken together, so a spec with 'data' on the layer dim gives a rank the
moments of whole layers).  `adamw_update` on such a state updates the
rank's block of each parameter and all-gathers the blocks
(`launch.mesh.gather`), so every rank ends with the whole parameter.
AdamW is elementwise and the gradients are replicated, so the result has
the bits of the update with replicated moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch.distributed.tensor import Shard

from repro_torch.kernels import sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import policy


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device: no host synchronisation)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(tree scaled by min(1, max_norm / norm), norm): new tensors."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, gn


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"mu": {...}, "nu": {...}, "step": 0}``, fp32 zero moments."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return {"mu": zeros, "nu": {k: z.clone() for k, z in zeros.items()},
            "step": 0}


def _adamw_leaf(cfg: AdamWConfig, g, mu, nu, p, lr, bc1, bc2):
    """The elementwise AdamW update of one leaf (or one block of it):
    the moments in place, the new parameter returned in fp32."""
    g = g.float()
    mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    pf = p.float()
    delta = ((mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
             + cfg.weight_decay * pf)
    return pf - lr * delta


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: dict, params: Mapping[str, torch.Tensor]):
    """One AdamW step, in place: returns ``(params, state, lr)`` with the
    same parameter and moment tensors updated and ``state["step"]`` up by
    one (read by `schedule` after the increment, as the JAX step).  On a
    `zero1_init` state each rank updates its blocks and gathers the
    parameters whole."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    if "zero1" in state:
        for key, leaf in state["zero1"].items():
            new = _adamw_leaf(cfg, leaf.block(grads), state["mu"][key],
                              state["nu"][key], leaf.block(params), lr, bc1,
                              bc2)
            leaf.scatter(leaf.gather(new), params)
    else:
        for k, p in params.items():
            p.copy_(_adamw_leaf(cfg, grads[k], state["mu"][k],
                                state["nu"][k], p, lr, bc1, bc2))
    state["step"] = step
    return params, state, lr


# ------------------------------------------------------------------ ZeRO-1

@dataclasses.dataclass(frozen=True)
class Zero1Leaf:
    """One stacked leaf of the JAX layout under ZeRO-1 on this rank.

    names: the flat parameter names of its layers, row-major over the
    leading layer dims `lead` (one name, lead (), for a top-level leaf);
    shape: the stacked shape; `ranges[d]`: this rank's (start, size)
    along dim d; `gathers`: (mesh dim, its process group, tensor dim)
    for every mesh dim that shards the leaf, in mesh order."""
    names: tuple
    lead: tuple
    shape: tuple
    ranges: tuple
    gathers: tuple

    def block(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """This rank's block of the stacked leaf, from the per-layer
        tensors (the whole layers of its range along the layer dims,
        each cut along its own dims)."""
        nl = len(self.lead)
        idx = torch.arange(len(self.names)).reshape(self.lead or ())
        for d in range(nl):
            idx = idx.narrow(d, *self.ranges[d])
        parts = []
        for i in idx.reshape(-1).tolist():
            t = tensors[self.names[i]]
            for d, (start, size) in enumerate(self.ranges[nl:]):
                t = t.narrow(d, start, size)
            parts.append(t)
        if not nl:
            return parts[0]
        return torch.stack(parts).reshape(
            *(size for _, size in self.ranges))

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole stacked leaf from every rank's block: one all-gather
        per sharding mesh dim, the last first (so blocks of two mesh dims
        on one tensor dim join row-major)."""
        for _, group, d in reversed(self.gathers):
            block = torch.cat(mesh_lib.gather(block, group).unbind(0),
                              dim=d)
        return block

    def scatter(self, whole: torch.Tensor, tensors: Mapping) -> None:
        """Copy the whole stacked leaf into its per-layer tensors."""
        flat = whole.reshape(len(self.names), *whole.shape[len(self.lead):])
        for name, t in zip(self.names, flat.unbind(0)):
            tensors[name].copy_(t)


def zero1_init(params: Mapping[str, torch.Tensor], specs: Mapping,
               mesh) -> dict:
    """An AdamW state whose moments are sharded ZeRO-1 style over `mesh`
    (a DeviceMesh, this rank's coordinate read from it).

    params: the flat parameters (``tree.flatten(params)``); specs:
    ``sharding.policy.flat_specs(cfg, zero1_pspecs(cfg, mesh))``, each
    flat name's stacked leaf, spec and layer index.  The leaf's
    placements (`policy.named`) set this rank's block along every dim;
    the moments are fp32 zeros of the block's shape, keyed by the leaf's
    path.  Returns ``{"mu", "nu", "step": 0, "zero1": {path:
    Zero1Leaf}}``; `adamw_update` takes it, `gather_moments` gives the
    moments whole by flat name."""
    sizes = policy.mesh_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    by_leaf: dict[str, list] = {}
    for name, leaf in specs.items():
        by_leaf.setdefault(leaf.path, []).append((leaf.index, name))
    state = {"mu": {}, "nu": {}, "step": 0, "zero1": {}}
    for path, members in by_leaf.items():
        members.sort()
        index, name = members[-1]
        lead = tuple(i + 1 for i in index)
        shape = (*lead, *params[name].shape)
        spec = specs[name].spec
        shards = [[] for _ in shape]
        gathers = []
        for dim, place in zip(sizes, policy.placements(mesh, spec)):
            if isinstance(place, Shard) and sizes[dim] > 1:
                shards[place.dim].append(dim)
                gathers.append((dim, mesh.get_group(dim), place.dim))
        ranges = []
        for d, dims in enumerate(shards):
            n = math.prod(sizes[a] for a in dims)
            i = 0
            for a in dims:
                i = i * sizes[a] + coord[a]
            size = shape[d] // n
            ranges.append((i * size, size))
        leaf = Zero1Leaf(tuple(n for _, n in members), lead, shape,
                         tuple(ranges), tuple(gathers))
        device = params[name].device
        block = tuple(size for _, size in ranges)
        state["mu"][path] = torch.zeros(block, dtype=torch.float32,
                                        device=device)
        state["nu"][path] = torch.zeros_like(state["mu"][path])
        state["zero1"][path] = leaf
    return state


def zero1_collectives(cfg, specs, mesh) -> list:
    """The gathers one `adamw_update` step on a `zero1_init` state makes
    (each leaf's new parameter block, fp32, gathered over every mesh dim
    that shards it, the last dim first), as `kernels.sharded.Collective`
    records: a pure function of `cfg`'s stacked shapes, the moment spec
    tree `specs` (``policy.zero1_pspecs`` or a variant of it) and the
    mesh (a DeviceMesh or a ``{dim: size}`` mapping)."""
    sizes = policy.mesh_sizes(mesh)
    out = []

    def walk(shape, spec):
        if isinstance(shape, Mapping):
            for k, v in shape.items():
                walk(v, spec[k])
            return
        if isinstance(shape, list):
            for v, sp in zip(shape, spec):
                walk(v, sp)
            return
        dims = [dim for dim, place in zip(sizes, policy.placements(
            sizes, spec)) if isinstance(place, Shard) and sizes[dim] > 1]
        nbytes = math.prod(shape) // math.prod(sizes[d] for d in dims) * 4
        for dim in reversed(dims):
            out.append(sharded.Collective("all_gather", dim, sizes[dim],
                                          nbytes, nbytes * sizes[dim]))
            nbytes *= sizes[dim]

    walk(policy.stacked_shapes(cfg), specs)
    return out


@torch.no_grad()
def gather_moments(state: dict) -> dict:
    """``{"mu", "nu": {flat name: whole fp32 tensor}, "step"}`` from a
    `zero1_init` state (every rank must call it: it gathers)."""
    out = {"mu": {}, "nu": {}, "step": state["step"]}
    for key in ("mu", "nu"):
        for path, leaf in state["zero1"].items():
            whole = leaf.gather(state[key][path])
            flat = whole.reshape(len(leaf.names),
                                 *whole.shape[len(leaf.lead):])
            out[key].update(zip(leaf.names, flat.unbind(0)))
    return out


def zero1_shard(moments: Mapping, layout: dict) -> dict:
    """The inverse of `gather_moments`: a `zero1_init` state in the layout
    of `layout` (a `zero1_init` state on this rank's mesh) holding this
    rank's blocks of the whole moments ``{"mu", "nu": {flat name:
    tensor}, "step"}`` (a restored checkpoint's; no collective)."""
    out = {"mu": {}, "nu": {}, "step": moments["step"],
           "zero1": layout["zero1"]}
    for key in ("mu", "nu"):
        for path, leaf in layout["zero1"].items():
            block = leaf.block(moments[key])
            out[key][path] = block.to(
                dtype=torch.float32,
                device=layout[key][path].device).contiguous().clone()
    return out


def sgdm_init(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"mom": {...}, "step": 0}``, fp32 zero momentum."""
    return {"mom": {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}, "step": 0}


@torch.no_grad()
def sgdm_update(grads: Mapping[str, torch.Tensor], state: dict,
                params: Mapping[str, torch.Tensor], lr: float = 1e-2,
                beta: float = 0.9):
    """mom = beta * mom + g; p -= lr * mom, in place.  Returns
    ``(params, state)``."""
    for k, p in params.items():
        mom = state["mom"][k]
        mom.mul_(beta).add_(grads[k].float())
        p.copy_(p.float() - lr * mom)
    state["step"] += 1
    return params, state
