"""The kernel set run per shard over a device mesh: distribution inside the
backend, kernels unchanged (PyTorch port of ``repro/kernels/sharded.py``).

The paper maps ONE full-precision network onto whatever compute a system
offers; partitioning is the toolflow's job, not the network's.  Here the
same fused-GEMM and attention wrappers `ops.py` exposes run per shard of
the mesh installed with `sharding.hints.use_mesh`, so model code never
forks on a mesh: the `sharded_cuda` backend (core/shard_backend.py)
decides distribution at dispatch.

Design.  Every rank holds the operands whole and replicated, as a single
card does.  A sharded op

  1. takes its rank's slice along the sharded dim, by the rank's
     coordinate in the mesh;
  2. runs the local kernel wrapper on that slice, so plans resolve from
     the PER-SHARD shapes under the usual keys (a shard's 2-row GEMM
     never inherits the global problem's plan);
  3. all-gathers the output over the sharded dims (`launch.mesh.gather`,
     one collective per sharded op);
  4. returns the whole tensor.

So model code, caches and engines run unchanged on every rank: this is
shard_map's arithmetic with replicated boundaries.  The JAX package keeps
its outputs sharded between ops and needs no collective on the batch and
heads paths; the port pays one output gather per sharded op instead.

Decisions, in order of preference (every op falls back to the local
wrapper off-mesh, on a one-rank mesh, or when nothing divides):

  GEMMs      : the (M, K) rows (the flattened token axis, im2col patch
               rows included) over the strategy's batch dims; weights and
               epilogue vectors replicated.  bmm shards B.
  attention  : batch over the strategy's batch dims, and KV-head groups
               over 'model' under strategy "tp" (query head h attends
               kv-head h // G, so a split into KV chunks never cuts a
               group).
  seq-split  : a decode-shaped dispatch that neither divides shards the
               KEY axis: each rank reduces its contiguous span to a
               partial (o, lse) with `ops.attention_partial` at the
               relative extent kv_len - offset, the partials are
               all-gathered in rank order and `flash_decode.combine`
               merges them: the split-KV merge across ranks.

`path_counts` counts the dispatches by path and `collective_counts` the
collectives (with the host-staged copies of `launch.mesh`), as the kernel
modules count their launches.  Forward only: the `sharded_cuda` backend
declares no op differentiable.
"""
from __future__ import annotations

import collections
import math

import torch

from repro_torch.kernels import flash_decode as decode_kernel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import hints

PATHS = ("matmul_rows", "matmul_local", "bmm_batch", "bmm_local",
         "attention_batch", "attention_heads", "attention_batch_heads",
         "attention_seq", "attention_local")

_PATHS = collections.Counter()
_COLLECTIVES = collections.Counter()


def path_counts() -> dict[str, int]:
    """Dispatches of the sharded ops by the path they took."""
    return {p: _PATHS[p] for p in PATHS}


def collective_counts() -> dict[str, int]:
    """All-gathers made by the sharded ops (``all_gather``, one per axis
    group crossed), and the host-staged copies of the transport."""
    return {"all_gather": _COLLECTIVES["all_gather"],
            **mesh_lib.staged_transfers()}


def reset_collectives() -> None:
    """Set the path, collective and staging counts to 0."""
    _PATHS.clear()
    _COLLECTIVES.clear()
    mesh_lib.reset_staged()


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_plan():
    """(mesh, batch_axes, model_axis) for the installed mesh, or None off
    a mesh or on a one-rank mesh (callers then run the local wrapper).

    batch_axes are the strategy's batch dims (`hints.batch_axes`: under
    "fsdp" the model dim carries batch) present with size > 1;
    model_axis is 'model' under strategy "tp" when present with size > 1,
    else None."""
    mesh = hints.physical_mesh()
    if mesh is None or mesh.size() <= 1:
        return None
    sizes = _sizes(mesh)
    batch = tuple(a for a in hints.batch_axes() if sizes.get(a, 1) > 1)
    model = ("model" if hints.current_strategy() == "tp"
             and sizes.get("model", 1) > 1 else None)
    return mesh, batch, model


def _axis_size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _axis_index(mesh, axes) -> int:
    """This rank's index along `axes`, row-major (the last dim fastest)."""
    sizes = _sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(n, *t.shape): every rank's `t` along `axes`, in the row-major
    order of `_axis_index`: one all-gather per dim, the last dim first."""
    out = t
    for a in reversed(axes):
        out = mesh_lib.gather(out, mesh.get_group(a))
        out = out.reshape(-1, *t.shape)
        _COLLECTIVES["all_gather"] += 1
    return out


def _gather_cat(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' slices along `axes` joined along `dim`."""
    return torch.cat(_gather(t, mesh, axes).unbind(0), dim=dim)


def _piece(t, i: int, n: int, dim: int):
    """Slice i of n equal slices of `t` along `dim` (a view)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


# ------------------------------------------------------------------ GEMMs ---

def matmul(x, w, scale=None, shift=None, *, act: str = "linear",
           out_dtype=None):
    """Row-sharded fused GEMM: the (M, K) rows over the batch dims, w and
    the (N,) epilogue vectors replicated, the output rows gathered.  Falls
    back to `ops.matmul` off-mesh or when the dims do not divide M."""
    plan = mesh_plan()
    n = _axis_size(plan[0], plan[1]) if plan else 1
    if n <= 1 or x.shape[0] % n:
        _PATHS["matmul_local"] += 1
        return kernel_ops.matmul(x, w, scale, shift, act=act,
                                 out_dtype=out_dtype)
    mesh, batch, _ = plan
    _PATHS["matmul_rows"] += 1
    y = kernel_ops.matmul(_piece(x, _axis_index(mesh, batch), n, 0), w,
                          scale, shift, act=act, out_dtype=out_dtype)
    return _gather_cat(y, mesh, batch, 0)


def bmm(x, w, *, out_dtype=None):
    """Batch-sharded (B, M, K) @ (B, K, N): both operands sliced along B
    over the batch dims.  Falls back to `ops.bmm` off-mesh or when B does
    not divide."""
    plan = mesh_plan()
    n = _axis_size(plan[0], plan[1]) if plan else 1
    if n <= 1 or x.shape[0] % n:
        _PATHS["bmm_local"] += 1
        return kernel_ops.bmm(x, w, out_dtype=out_dtype)
    mesh, batch, _ = plan
    _PATHS["bmm_batch"] += 1
    i = _axis_index(mesh, batch)
    y = kernel_ops.bmm(_piece(x, i, n, 0), _piece(w, i, n, 0),
                       out_dtype=out_dtype)
    return _gather_cat(y, mesh, batch, 0)


# -------------------------------------------------------------- attention ---

def _local_attention(q, k, v, kv_len, sm_scale, *, causal):
    """The single-card dispatch, the formulation choice included
    (`core/backends.py::_cuda_attention`): a decode-shaped problem takes
    the split-KV kernel, the rest the forward kernel; plans resolve from
    these operands' shapes."""
    if kernel_ops.use_decode_formulation(q.shape[1], k.shape[1]):
        return kernel_ops.attention_decode(q, k, v, kv_len, sm_scale,
                                           causal=causal)
    return kernel_ops.attention(q, k, v, kv_len, sm_scale, causal=causal)


def attention(q, k, v, kv_len=None, sm_scale=None, *, causal: bool = True):
    """Mesh-sharded grouped attention with `ops.attention`'s operand
    contract.  sm_scale is folded into q first (`ops.scale_queries`; the
    local wrappers' fold of the remaining 1.0 is exact).  Then the first
    path that fits: batch rows over the batch dims and / or KV-head
    groups over 'model' (strategy "tp"); a decode-shaped dispatch that
    neither divides splits the key axis (`_seq_split_attention`); else the
    local dispatch."""
    kernel_ops.validate_attention_shapes(q, k, v)
    b, sq, _, _ = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kernel_ops.validate_kv_len(kv_len, b)
    plan = mesh_plan()
    if plan is None:
        _PATHS["attention_local"] += 1
        return _local_attention(q, k, v, kv_len, sm_scale, causal=causal)
    mesh, batch, model = plan
    q, sm_scale = kernel_ops.scale_queries(q, sm_scale), 1.0
    n_b = _axis_size(mesh, batch)
    batch = batch if (n_b > 1 and b % n_b == 0) else ()
    n_m = _sizes(mesh)[model] if model else 1
    heads = model if (model and kvh % n_m == 0) else None
    kvl = (None if kv_len is None else torch.as_tensor(
        kv_len, device=q.device).to(torch.int32).reshape(-1).expand(b))
    if batch or heads:
        _PATHS["attention_" + ("batch_heads" if batch and heads else
                               "batch" if batch else "heads")] += 1
        if batch:
            i = _axis_index(mesh, batch)
            q, k, v = (_piece(t, i, n_b, 0) for t in (q, k, v))
            kvl = None if kvl is None else _piece(kvl, i, n_b, 0)
        if heads:
            i = _axis_index(mesh, (heads,))
            q, k, v = (_piece(t, i, n_m, 2) for t in (q, k, v))
        o = _local_attention(q, k, v, kvl, sm_scale, causal=causal)
        if heads:
            o = _gather_cat(o, mesh, (heads,), 2)
        return _gather_cat(o, mesh, batch, 0) if batch else o
    seq_axes = tuple(a for a, n in _sizes(mesh).items() if n > 1)
    n_s = _axis_size(mesh, seq_axes)
    if skv % n_s == 0 and kernel_ops.use_decode_formulation(sq, skv):
        _PATHS["attention_seq"] += 1
        return _seq_split_attention(q, k, v, kvl, mesh, seq_axes,
                                    causal=causal)
    _PATHS["attention_local"] += 1
    return _local_attention(q, k, v, kvl, sm_scale, causal=causal)


def _seq_split_attention(q, k, v, kvl, mesh, axes, *, causal):
    """Sequence split over `axes`, q already scaled: each rank owns one
    contiguous key span and reduces it to a span-normalised partial (o,
    lse) at the RELATIVE extent kv_len - offset, which keeps the length
    mask and the right-aligned causal diagonal span-locally
    (`ops.attention_partial`).  One all-gather of (o, lse) packed side by
    side crosses the span boundary, and every rank merges the partials in
    rank order with `flash_decode.combine`, so the output comes back
    whole on every rank."""
    b, sq, _, _ = q.shape
    skv = k.shape[1]
    n = _axis_size(mesh, axes)
    span = skv // n
    if kvl is None:
        kvl = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    i = _axis_index(mesh, axes)
    o, lse = kernel_ops.attention_partial(
        q, _piece(k, i, n, 1), _piece(v, i, n, 1), kvl - i * span, 1.0,
        causal=causal)
    packed = torch.cat([o.float(), lse[..., None]], dim=-1)
    parts = _gather(packed, mesh, axes)            # (n, B, H, Sq, D + 1)
    out = decode_kernel.combine(parts[..., :-1].movedim(0, 2),
                                parts[..., -1].movedim(0, 2))
    return out.transpose(1, 2).to(q.dtype)
