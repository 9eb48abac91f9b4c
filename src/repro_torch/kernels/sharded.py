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

Backward.  Three autograd primitives carry a sharded op's gradient, so
the local wrappers keep their own autograd inside the slice (`GemmFused`,
`BmmFn`, `FlashAttention` run the dX / dW and dQ / dK / dV kernels at the
per-shard shapes, their plans under the `cuda` keys):

  `_Slice`     a sliced operand (x's rows, q / k / v by batch or KV-head
               group): forward this rank's slice, backward the all-gather
               of every rank's slice cotangent in the same dims and order;
  `_Gathered`  a gathered output: forward the all-gather, backward this
               rank's slice of the cotangent (the cotangent is replicated,
               as the loss is);
  `_Summed`    a whole operand every rank reads (w, scale, shift on the row
               path): forward the identity, backward the ranks' partial
               cotangents summed in rank order (`launch.mesh.sum_over`),
               so every rank gets the same bits.

The sequence split stays inference only, as JAX's `attention_partial`.

`path_counts` counts the dispatches by path and `collective_counts` the
collectives (with the host-staged copies of `launch.mesh`), as the kernel
modules count their launches.

`route` is the decision above as a pure function of (op, operand shapes,
mesh sizes, strategy): the path, and the collectives the path issues
forward and under grad, with their bytes.  The wrappers call it, and so
does the dry run (launch/dryrun.py), which reads a step's dispatch log
through `predict` without a mesh or a process group.
"""
from __future__ import annotations

import collections
import math
from typing import NamedTuple

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
    """All-gathers made by the sharded ops and their backward
    (``all_gather``, one per axis group crossed), the rank-order sums of
    the backward (``sum``, one per axis group, each one all-gather and
    the adds), and the host-staged copies of the transport."""
    return {"all_gather": _COLLECTIVES["all_gather"],
            "sum": _COLLECTIVES["sum"], **mesh_lib.staged_transfers()}


def reset_collectives() -> None:
    """Set the path, collective and staging counts to 0."""
    _PATHS.clear()
    _COLLECTIVES.clear()
    mesh_lib.reset_staged()


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(sizes: dict, strategy: str):
    """(batch_axes, model_axis) of a mesh of `sizes` under `strategy`, or
    None for a mesh of one rank (see `mesh_plan`)."""
    if math.prod(sizes.values()) <= 1:
        return None
    batch = tuple(a for a in hints.batch_axes(strategy)
                  if sizes.get(a, 1) > 1)
    model = ("model" if strategy == "tp" and sizes.get("model", 1) > 1
             else None)
    return batch, model


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
    return (mesh, *_axes(_sizes(mesh), hints.current_strategy()))


# ------------------------------------------------------------------ route ---

class Collective(NamedTuple):
    """One collective of a path: ``kind`` "all_gather" or "sum" (one
    all-gather and the adds), over mesh dim ``dim`` of ``ranks`` ranks.
    Each rank sends ``in_bytes`` and holds ``out_bytes`` after the
    gather: the sizes of the two host-staged copies on a card."""
    kind: str
    dim: str
    ranks: int
    in_bytes: int
    out_bytes: int


class Route(NamedTuple):
    """Where one dispatch goes on a mesh: the path (None for an op the
    backend runs unsharded: ``ssd``, ``einsum``), the mesh dims it
    slices (the batch dims, or the key axis's dims on the sequence
    split), the KV-head dim ('model' or None), and the collectives it
    issues forward and under grad."""
    path: str | None
    axes: tuple = ()
    heads: str | None = None
    forward: tuple = ()
    backward: tuple = ()


def _gathers(nbytes: int, sizes: dict, axes, kind: str = "all_gather"
             ) -> list:
    """The collectives of `_gather` (kind "all_gather") or `_sum`
    ("sum") of a tensor of `nbytes` over `axes`: one per dim, the last
    dim first; a gather's result feeds the next dim's."""
    out = []
    for a in reversed(axes):
        out.append(Collective(kind, a, sizes[a], nbytes, nbytes * sizes[a]))
        if kind == "all_gather":
            nbytes *= sizes[a]
    return out


def _flags(grad, n: int) -> tuple:
    return (tuple(grad) + (False,) * n)[:n]


def route(op: str, shapes: tuple, sizes: dict, strategy: str = "tp", *,
          itemsize: int = 4, grad: tuple = ()) -> Route:
    """The path a dispatch of `op` takes on a mesh of `sizes` ({dim:
    size}) under `strategy`, and the collectives it issues.

    shapes: the operands' dims, as the engine logs them: ``matmul``
    (M, K, N), ``conv2d`` ((B, H, W, C), Cout, size, stride, pad) (its
    im2col GEMM), ``bmm`` (B, M, K, N), ``attention`` (q's (B, Sq, H, D),
    k's (B, Skv, KV, D)); any other op runs unsharded (path None).
    itemsize: bytes an element of the operands and outputs (the compute
    dtype's; the sequence split's partials are fp32).  grad: which
    operands autograd differentiates, in the engine's order (x, w,
    scale, shift / x, w / q, k, v): each adds its `_Slice` gathers or
    `_Summed` sums to ``backward`` (scale and shift are fp32)."""
    plan = _axes(sizes, strategy)
    if op in ("matmul", "conv2d"):
        if op == "conv2d":
            (b, h, w, c), cout, size, stride, pad = shapes
            oh = (h + 2 * pad - size) // stride + 1
            ow = (w + 2 * pad - size) // stride + 1
            m, k, n = b * oh * ow, size * size * c, cout
        else:
            m, k, n = shapes
        batch = plan[0] if plan else ()
        ranks = math.prod(sizes[a] for a in batch)
        if ranks <= 1 or m % ranks:
            return Route("matmul_local")
        gx, gw, gs, gh = _flags(grad, 4)
        back = _gathers(m // ranks * k * itemsize, sizes, batch) if gx \
            else []
        for on, nbytes in ((gw, k * n * itemsize), (gs, n * 4), (gh, n * 4)):
            if on:
                back += _gathers(nbytes, sizes, batch, "sum")
        return Route("matmul_rows", batch, None, tuple(_gathers(
            m // ranks * n * itemsize, sizes, batch)), tuple(back))
    if op == "bmm":
        b, m, k, n = shapes
        batch = plan[0] if plan else ()
        ranks = math.prod(sizes[a] for a in batch)
        if ranks <= 1 or b % ranks:
            return Route("bmm_local")
        per = b // ranks * itemsize
        back = []
        for on, nbytes in zip(_flags(grad, 2), (per * m * k, per * k * n)):
            if on:
                back += _gathers(nbytes, sizes, batch)
        return Route("bmm_batch", batch, None,
                     tuple(_gathers(per * m * n, sizes, batch)), tuple(back))
    if op != "attention":
        return Route(None)
    (b, sq, h, d), (_, skv, kvh, _) = shapes
    if plan is None:
        return Route("attention_local")
    batch, model = plan
    n_b = math.prod(sizes[a] for a in batch)
    batch = batch if (n_b > 1 and b % n_b == 0) else ()
    n_m = sizes[model] if model else 1
    heads = model if (model and kvh % n_m == 0) else None
    if batch or heads:
        path = "attention_" + ("batch_heads" if batch and heads else
                               "batch" if batch else "heads")
        bb = b // n_b if batch else b
        split = n_m if heads else 1

        def pieces(s, nh):
            out = []
            if heads:
                out += _gathers(bb * s * nh // split * d * itemsize, sizes,
                                (heads,))
            if batch:
                out += _gathers(bb * s * nh * d * itemsize, sizes, batch)
            return out

        back = []
        for on, s, nh in zip(_flags(grad, 3), (sq, skv, skv), (h, kvh, kvh)):
            if on:
                back += pieces(s, nh)
        return Route(path, batch, heads, tuple(pieces(sq, h)), tuple(back))
    seq_axes = tuple(a for a, n in sizes.items() if n > 1)
    n_s = math.prod(sizes[a] for a in seq_axes)
    if skv % n_s == 0 and kernel_ops.use_decode_formulation(sq, skv):
        return Route("attention_seq", seq_axes, None, tuple(_gathers(
            b * h * sq * (d + 1) * 4, sizes, seq_axes)))
    return Route("attention_local")


def _itemsize(dtype) -> int:
    if dtype is None:
        return 4
    name = str(dtype).removeprefix("torch.")
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def predict(log, sizes: dict, strategy: str = "tp", *,
            staged: bool = False, extra=()) -> dict:
    """What `collective_counts` and `path_counts` would read after the
    dispatches of `log` (`core.backends.dispatch_log` records: ``op``,
    ``shapes``, ``dtype``, ``grad``, the per-operand flags, on a
    dispatch autograd differentiates, and ``cut`` on one a recompute
    stopped inside) on a mesh of `sizes` under
    `strategy`, with `extra` collectives besides (the ZeRO-1 optimizer's
    gathers: `optimizer.zero1_collectives`).  With `staged` (CUDA
    operands) every gather is copied to the host and back.  Returns
    ``{"paths", "collectives", "link_bytes"}``: the path counts, the
    counts in `collective_counts`' keys, and the bytes the collectives
    put through a rank's links (each gather's result, as JAX's roofline
    counts an all-gather)."""
    paths = collections.Counter()
    coll = collections.Counter()
    for rec in log:
        shapes = rec["shapes"]
        if rec["op"] == "bmm":
            shapes = (rec.get("batch", 1), *shapes)
        r = route(rec["op"], shapes, sizes, strategy,
                  itemsize=_itemsize(rec.get("dtype")),
                  grad=rec.get("grad", ()))
        if r.path is not None:
            paths[r.path] += 1
        # a dispatch cut short by a recompute's early stop ran its kernel
        # (which saved what the backward needs) but not its gathers
        for c in (*(() if rec.get("cut") else r.forward), *r.backward):
            coll[c.kind] += 1
            coll["link_bytes"] += c.out_bytes
            if staged:
                coll["to_host_bytes"] += c.in_bytes
                coll["to_device_bytes"] += c.out_bytes
    for c in extra:
        coll["link_bytes"] += c.out_bytes
        if staged:
            coll["to_host_bytes"] += c.in_bytes
            coll["to_device_bytes"] += c.out_bytes
    n = coll["all_gather"] + coll["sum"] + (len(extra) if staged else 0)
    if staged:
        coll["to_host"] = coll["to_device"] = n
    return {"paths": {p: paths[p] for p in PATHS},
            "collectives": {k: coll[k] for k in (
                "all_gather", "sum", "to_host", "to_host_bytes",
                "to_device", "to_device_bytes")},
            "link_bytes": coll["link_bytes"]}


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


def _sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """`t` summed over the ranks along `axes`, in rank order, one group
    sum per dim, the last dim first (every rank gets the same bits)."""
    for a in reversed(axes):
        t = mesh_lib.sum_over(t, mesh.get_group(a))
        _COLLECTIVES["sum"] += 1
    return t


class _Slice(torch.autograd.Function):
    """A sliced operand: this rank's slice of `t` along `dim` over
    `axes`; its cotangent is the ranks' slice cotangents all-gathered and
    joined along `dim`, whole on every rank."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _piece(t, _axis_index(mesh, axes), _axis_size(mesh, axes),
                      dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Gathered(torch.autograd.Function):
    """A gathered output: the ranks' slices of `t` over `axes` joined
    along `dim`; its cotangent is this rank's slice of the (replicated)
    output cotangent."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather_cat(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_piece(g, _axis_index(ctx.mesh, ctx.axes),
                       _axis_size(ctx.mesh, ctx.axes), ctx.dim).contiguous(),
                None, None, None)


class _Summed(torch.autograd.Function):
    """A whole operand every rank reads: the identity (a view, strides
    kept: a tied head's transposed table stays transposed); its cotangent
    is the ranks' partial cotangents summed over `axes` in rank order."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


def _summed(t, mesh, axes):
    """`t` through `_Summed` when autograd will differentiate it, else
    `t` itself (None stays None)."""
    if not kernel_ops.needs_grad(t):
        return t
    return _Summed.apply(t, mesh, axes)


# ------------------------------------------------------------------ GEMMs ---

def matmul(x, w, scale=None, shift=None, *, act: str = "linear",
           out_dtype=None):
    """Row-sharded fused GEMM: the (M, K) rows over the batch dims, w and
    the (N,) epilogue vectors replicated, the output rows gathered; under
    grad dX's rows are gathered and dW, dscale and dshift summed over the
    ranks.  Falls back to `ops.matmul` off-mesh or when the dims do not
    divide M."""
    mesh = hints.physical_mesh()
    r = route("matmul", (x.shape[0], x.shape[1], w.shape[1]),
              _sizes(mesh) if mesh is not None else {},
              hints.current_strategy())
    _PATHS[r.path] += 1
    if r.path == "matmul_local":
        return kernel_ops.matmul(x, w, scale, shift, act=act,
                                 out_dtype=out_dtype)
    batch = r.axes
    w, scale, shift = (_summed(t, mesh, batch) for t in (w, scale, shift))
    y = kernel_ops.matmul(_Slice.apply(x, mesh, batch, 0), w, scale, shift,
                          act=act, out_dtype=out_dtype)
    return _Gathered.apply(y, mesh, batch, 0)


def bmm(x, w, *, out_dtype=None):
    """Batch-sharded (B, M, K) @ (B, K, N): both operands sliced along B
    over the batch dims (under grad both cotangents gathered along B).
    Falls back to `ops.bmm` off-mesh or when B does not divide."""
    mesh = hints.physical_mesh()
    r = route("bmm", (*x.shape, w.shape[-1]),
              _sizes(mesh) if mesh is not None else {},
              hints.current_strategy())
    _PATHS[r.path] += 1
    if r.path == "bmm_local":
        return kernel_ops.bmm(x, w, out_dtype=out_dtype)
    batch = r.axes
    y = kernel_ops.bmm(_Slice.apply(x, mesh, batch, 0),
                       _Slice.apply(w, mesh, batch, 0), out_dtype=out_dtype)
    return _Gathered.apply(y, mesh, batch, 0)


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
    groups over 'model' (strategy "tp"), under grad the q / k / v
    cotangents gathered the same way; a decode-shaped dispatch that
    neither divides splits the key axis (`_seq_split_attention`, inference
    only); else the local dispatch."""
    kernel_ops.validate_attention_shapes(q, k, v)
    b = q.shape[0]
    kernel_ops.validate_kv_len(kv_len, b)
    mesh = hints.physical_mesh()
    r = route("attention", (tuple(q.shape), tuple(k.shape)),
              _sizes(mesh) if mesh is not None else {},
              hints.current_strategy())
    _PATHS[r.path] += 1
    if mesh is None or mesh.size() <= 1:   # off a mesh: q as given
        return _local_attention(q, k, v, kv_len, sm_scale, causal=causal)
    q, sm_scale = kernel_ops.scale_queries(q, sm_scale), 1.0
    kvl = (None if kv_len is None else torch.as_tensor(
        kv_len, device=q.device).to(torch.int32).reshape(-1).expand(b))
    if r.path == "attention_seq":
        return _seq_split_attention(q, k, v, kvl, mesh, r.axes,
                                    causal=causal)
    if r.path == "attention_local":
        return _local_attention(q, k, v, kvl, sm_scale, causal=causal)
    batch, heads = r.axes, r.heads
    n_b = _axis_size(mesh, batch)
    if batch:
        q, k, v = (_Slice.apply(t, mesh, batch, 0) for t in (q, k, v))
        kvl = None if kvl is None else _piece(
            kvl, _axis_index(mesh, batch), n_b, 0)
    if heads:
        q, k, v = (_Slice.apply(t, mesh, (heads,), 2) for t in (q, k, v))
    o = _local_attention(q, k, v, kvl, sm_scale, causal=causal)
    if heads:
        o = _Gathered.apply(o, mesh, (heads,), 2)
    return _Gathered.apply(o, mesh, batch, 0) if batch else o


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
