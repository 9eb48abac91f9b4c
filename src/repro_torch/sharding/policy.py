"""Sharding policy: partition specs for parameters, optimizer moments and
inputs (PyTorch port of ``repro/sharding/policy.py``).

Rules (TP = 'model' dim, DP = ('pod', 'data')), as in the JAX package:
  * column-parallel:  wq/wk/wv, mlp wg/wu, w_uk/w_uv, win    (None, 'model')
  * row-parallel:     wo, mlp wd, mixer out, wout            ('model', None)
  * expert-parallel:  moe wg/wu/wd (E leading)               ('model', ...)
  * vocab-parallel:   embed (V, D) ('model', None); lm_head (None, 'model')
  * SSM head-parallel: wz/wx/conv_x/mixer-norm on d_inner    ('model')
  * small tensors (router, B/C/dt proj, norms, frontend): replicated
  * FSDP (opt-in, or by `needs_fsdp`): an extra 'data' on the largest
    divisible free dim of every leaf of at least 2**20 elements
  * ZeRO-1: optimizer moments always take the FSDP treatment

A spec is a tuple with one entry per dim of the leaf: None, a mesh dim
name, or a tuple of names (JAX's PartitionSpec as a tuple).  The spec
trees have JAX's nested parameter layout, the layout of
`convert.lm_params_to_numpy(params, cfg)`: the layers of each program
entry stacked under ``stacks[e]`` behind one leading layer dim (two for
a hybrid super entry).  Every rule, the 2**20 threshold included, reads
that STACKED shape, as JAX's does; so 'data' may land on the layer dim
itself (under ``strategy="fsdp"``), which no per-layer spec can say.
`flat_specs` maps each of the port's flat parameter names
(``"layers.3.attn.wk"``) to its stack's leaf, spec and layer index.

Shapes come from `transformer.init_params` on the ``meta`` device: no
memory at any width.  A mesh is a ``DeviceMesh`` (its ``mesh_dim_names``
and ``shape``) or a ``{dim: size}`` mapping.
"""
from __future__ import annotations

import copy
import functools
import math
from typing import Mapping, NamedTuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models import transformer as tfm

_BIG = 1 << 20  # leaves at or above this take FSDP / ZeRO sharding


def mesh_sizes(mesh) -> dict[str, int]:
    """``{dim: size}`` of a DeviceMesh or a mapping, in mesh order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(a): int(n) for a, n in zip(mesh.mesh_dim_names, mesh.shape)}


def _dp_axes(sizes) -> tuple:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _leaf_spec(keys: list, shape) -> tuple:
    name = keys[-1]
    ctx = set(keys)
    nd = len(shape)

    if "mixer" in ctx:
        if name in ("wz", "wx"):
            return (None, "model")
        if name == "conv_x":
            return (None, "model")
        if name == "conv_x_b":
            return ("model",)
        if name == "out":
            return ("model", None)
        if name == "scale":
            return ("model",)
        return (None,) * nd
    if name in ("wg", "wu", "wd") and nd == 3:          # routed experts (EP)
        return ("model", None, None)
    if name in ("wq", "wk", "wv", "w_uk", "w_uv", "wg", "wu", "win"):
        return (None, "model")
    if name in ("bq", "bk", "bv"):
        return ("model",)
    if name in ("wo", "wd", "wout"):
        return ("model", None)
    if name == "tokens" and "embed" in ctx:
        return ("model", None)
    if name == "w" and "lm_head" in ctx:
        return (None, "model")
    return (None,) * nd


def _add_fsdp(spec: tuple, shape: tuple, data_size: int) -> tuple:
    """Insert 'data' into the largest free dim that divides evenly."""
    best, best_dim = None, 0
    for i, (s, d) in enumerate(zip(spec, shape)):
        if s is None and d % data_size == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return spec
    out = list(spec)
    out[best] = "data"
    return tuple(out)


def _maximal_spec(shape: tuple, sizes: dict) -> tuple:
    """Pure-FSDP (ZeRO-3) spec: 'model' then 'data' (('pod', 'data') with
    a pod dim) on the largest divisible free dims; leaves under 65536
    elements stay replicated."""
    if math.prod(shape) < 65536:
        return (None,) * len(shape)
    spec: list = [None] * len(shape)
    axes = []
    if "model" in sizes:
        axes.append("model")
    if "data" in sizes:
        axes.append(("pod", "data") if "pod" in sizes else "data")
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for ax in axes:
        size = (sizes[ax] if isinstance(ax, str)
                else math.prod(sizes[a] for a in ax))
        for i in order:
            if spec[i] is None and shape[i] % size == 0:
                spec[i] = ax
                break
    return tuple(spec)


def stacked_shapes(cfg) -> dict:
    """The parameter shapes in JAX's nested layout: ``torch.Size`` leaves
    under the keys of `convert.lm_params_to_numpy` (each program entry's
    layers stacked under ``stacks[e]``).  A fresh tree each call."""
    return copy.deepcopy(_stacked_shapes(cfg))


@functools.lru_cache(maxsize=32)
def _stacked_shapes(cfg) -> dict:
    params = tfm.init_params(cfg, generator=None, device="meta")

    def shapes(tree, lead=()):
        if isinstance(tree, Mapping):
            return {k: shapes(v, lead) for k, v in tree.items()}
        return torch.Size((*lead, *tree.shape))

    out = {k: shapes(v) for k, v in params.items() if k != "layers"}
    out["stacks"], first = [], 0
    for kind, n in tfm.stack_program(cfg):
        lead = (n, cfg.attn_every) if kind == "zamba_super" else (n,)
        out["stacks"].append(shapes(params["layers"][first], lead))
        first += tfm.entry_layers(kind, n, cfg)
    return out


def _map_with_keys(fn, tree, keys=()):
    """`fn(keys, leaf)` over a tree of dicts and lists, keys as JAX's
    path entries name them (a dict key, or ``"[i]"`` for a list index)."""
    if isinstance(tree, Mapping):
        return {k: _map_with_keys(fn, v, (*keys, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_keys(fn, v, (*keys, f"[{i}]"))
                for i, v in enumerate(tree)]
    return fn(list(keys), tree)


def param_pspecs(cfg, mesh, *, fsdp: bool = False, strategy: str = "tp"):
    """Spec tree matching the JAX layout of `cfg`'s parameters.

    strategy='tp' (baseline): Megatron TP rules plus, with `fsdp`, the
    'data' dim on the largest divisible free dim of every leaf of at least
    2**20 elements.  strategy='fsdp': pure ZeRO-3, every leaf of at least
    65536 elements sharded over 'model' and 'data'.  A stacked leaf's
    leading layer dims get None under 'tp'; a dim its mesh dims do not
    divide gets None."""
    sizes = mesh_sizes(mesh)
    tree = stacked_shapes(cfg)
    if strategy == "fsdp":
        return _map_with_keys(lambda keys, shape: _maximal_spec(
            tuple(shape), sizes), tree)
    data_size = sizes.get("data", 1)

    def make(keys, shape):
        shape = tuple(shape)
        base = _leaf_spec(keys, shape)
        if "stacks" in keys:
            # rules are written for one layer's rank: the surplus leading
            # dims are the stack's
            for lead in (1, 2):
                cand = _leaf_spec(keys, shape[lead:])
                if len(cand) == len(shape) - lead:
                    base = (None,) * lead + cand
                    break
            else:
                base = (None,) * len(shape)
        if len(base) != len(shape):
            base = (None,) * len(shape)
        if fsdp and math.prod(shape) >= _BIG:
            base = _add_fsdp(base, shape, data_size)
        out = []
        for s, d in zip(base, shape):
            if s is None:
                out.append(None)
                continue
            size = (sizes.get(s, 1) if isinstance(s, str)
                    else math.prod(sizes.get(a, 1) for a in s))
            out.append(s if d % size == 0 else None)
        return tuple(out)

    return _map_with_keys(make, tree)


def zero1_pspecs(cfg, mesh, strategy: str = "tp"):
    """Optimizer-moment specs: the parameters' with the FSDP 'data' dim
    forced (ZeRO-1)."""
    return param_pspecs(cfg, mesh, fsdp=True, strategy=strategy)


def needs_fsdp(cfg, mesh, hbm_bytes: float | None = None) -> bool:
    """Whether fp32 parameters and two fp32 moments overflow half of a
    rank's memory after TP alone.  `hbm_bytes` defaults to the total
    memory of CUDA device 0 (RuntimeError without a card); the JAX
    package's default, 16e9, is a TPU's."""
    if hbm_bytes is None:
        if not torch.cuda.is_available():
            raise RuntimeError("needs_fsdp reads the card's memory; pass "
                               "hbm_bytes without a CUDA device")
        hbm_bytes = torch.cuda.get_device_properties(0).total_memory
    total, _ = tfm.param_counts(cfg)
    per_rank = total * 4 * 3 / mesh_sizes(mesh).get("model", 1)
    return per_rank > 0.5 * hbm_bytes


def batch_pspecs(specs: Mapping, mesh, strategy: str = "tp") -> dict:
    """Input specs: the batch dim over the data-parallel dims (under
    "fsdp" every dim) when they divide it, else replicated.  `specs`
    maps each input's name to anything with a ``shape`` (a tensor, a
    meta tensor)."""
    sizes = mesh_sizes(mesh)
    if strategy == "fsdp":
        dp = tuple(a for a in ("pod", "data", "model") if a in sizes)
    else:
        dp = _dp_axes(sizes)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    out = {}
    for k, v in specs.items():
        shape = tuple(v.shape)
        if not shape:
            out[k] = ()
            continue
        # one dim as its name, as a PartitionSpec holds it
        lead = ((dp[0] if len(dp) == 1 else dp)
                if dp and shape[0] % dp_size == 0 else None)
        out[k] = (lead, *([None] * (len(shape) - 1)))
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        s is None or isinstance(s, (str, tuple)) for s in x)


def placements(mesh, spec: tuple) -> tuple:
    """One ``torch.distributed.tensor`` placement per mesh dim, in mesh
    order: ``Shard(d)`` where the spec names that mesh dim at tensor dim
    d, else ``Replicate()``.  Spec names absent from the mesh are
    dropped (a size-1 dim)."""
    out = []
    for dim in mesh_sizes(mesh):
        at = [d for d, s in enumerate(spec)
              if s == dim or (isinstance(s, tuple) and dim in s)]
        out.append(Shard(at[0]) if at else Replicate())
    return tuple(out)


def named(mesh, spec_tree):
    """The spec tree as placements (`placements`): for each leaf a tuple
    of ``torch.distributed.tensor`` ``Shard`` / ``Replicate``, one per
    mesh dim (JAX's NamedSharding over the mesh)."""
    if _is_spec(spec_tree):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, Mapping):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return [named(mesh, v) for v in spec_tree]


class LeafSpec(NamedTuple):
    """Where one of the port's flat parameters sits in the JAX layout: the
    stacked leaf's dotted path (``"stacks.0.attn.wk"``), its spec, and
    the layer's index along the leaf's leading layer dims (() for a
    top-level leaf, (i,) in a stack, (i, j) in a hybrid super entry)."""
    path: str
    spec: tuple
    index: tuple


def flat_specs(cfg, spec_tree) -> dict[str, LeafSpec]:
    """``{flat port name: LeafSpec}`` for every parameter of
    `tree.flatten(params)` (``"embed.tokens"``, ``"layers.3.attn.wk"``)
    under a spec tree in the JAX layout."""
    out: dict[str, LeafSpec] = {}

    def walk(tree, path, flat, index):
        if _is_spec(tree):
            out[flat] = LeafSpec(path, tree, index)
            return
        for k, v in tree.items():
            walk(v, f"{path}.{k}", f"{flat}.{k}", index)

    # in the order of `tree.flatten(params)`
    for key in tfm.init_params(cfg, generator=None, device="meta"):
        if key != "layers":
            walk(spec_tree[key], key, key, ())
            continue
        first = 0
        for e, ((kind, n), stack) in enumerate(zip(tfm.stack_program(cfg),
                                                   spec_tree["stacks"])):
            for j in range(tfm.entry_layers(kind, n, cfg)):
                index = (divmod(j, cfg.attn_every) if kind == "zamba_super"
                         else (j,))
                walk(stack, f"stacks.{e}", f"layers.{first + j}", index)
            first += tfm.entry_layers(kind, n, cfg)
    return out
