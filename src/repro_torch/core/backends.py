"""Backend/op registry for the compute engine (PyTorch port of
``repro/core/backends.py``).

The paper's claim is that ONE full-precision compute engine serves every
dense layer of a CNN (conv-as-im2col, FC, deconv).  This module is the
software form of that claim: a fixed op set (`OP_SET`), a
`register_backend` / `get_backend` API so execution targets plug in without
touching `ComputeEngine`, a per-process autotune cache so plan picks are
made once per (op, shapes, dtype, backend) and reused, and dispatch
counters plus a bounded dispatch log.  The cache resolves picks under a
policy (`off | heuristic | measure`, see `set_autotune_policy`): "measure"
times a candidate set on the card on first sight of a key and persists
the winner to a per-device table (core/autotune.py), so a second process
on the same device measures nothing.

Built-in backends:

  ref    : the plain oracles of kernels/ref.py.
  eager  : PyTorch formulations with the same precision policy and the same
           fused epilogue; the counterpart of the JAX package's `xla`, and
           the path every module runs on the CPU.
  cuda   : the hand-written Hopper kernels (kernels/gemm.py).  It takes CUDA
           tensors only: given a CPU tensor it raises, it never falls back.

Each backend registers every op of `OP_SET`: `matmul`, `bmm`, `conv2d`,
`attention`, `ssd` and `einsum`.  Each backend declares which ops
autograd may flow through (`differentiable`, as the JAX registry's
autodiff capability):
`ref` and `eager` are plain differentiable PyTorch, and `cuda` carries
`kernels/gemm.py::GemmFused`, whose backward runs the dX / dW kernels,
`kernels/gemm.py::BmmFn`, whose backward runs the batched dX / dW
kernels, and `kernels/flash_attention.py::FlashAttention`, whose backward
runs the dQ / dK / dV kernels.  The direct convolution
(`kernels/conv_direct.py`) is forward only and no backend registers it,
as in the JAX package; a backend that does must leave `conv2d` out of
`differentiable`.  A backend may also name dispatches of a
differentiable op that stay inference only (`inference_only`): on `cuda`
a decode-shaped `attention` (`kernel_ops.use_decode_formulation`) takes
the split-KV decode kernel, which has no backward, as in the JAX package.
The SSD chunk-scan kernel has no backward either (the JAX kernel has no
VJP), so an `ssd` dispatch on `cuda` under grad takes the einsum form
the JAX package trains through (`models/ssm.py::ssd_chunked`, here
`_eager_ssd`) and counts it in `kernels/ssd.py::einsum_dispatches`;
every dispatch without grad (serving, prefill) launches the kernel.
The engine calls `guard_grad` on every dispatch, so an op that a backend
does not declare differentiable, or an inference-only dispatch, raises a
clear NotImplementedError when it is dispatched with grad enabled on an
operand that requires it.  The
`cuda` backend resolves every GEMM and attention plan through the autotune
cache (`tile_plan`): its picker is the shape rules
(`kernels/ops.py::default_tiles`, `bmm_plan_for`, `gemm.bwd_plan_for`,
`flash_attention.plan_for` / `bwd_plan_for`, `decode_splits`), its
candidates the instantiated plans and its bench one launch of a kernel
(`kernels/ops.py`'s autotune surface).  The split counts of the backward
GEMMs and of the decode set the bits, so no policy changes them.

Op contract (`ctx` is an `OpContext` carrying the engine's precision policy
and the tile plan):

  matmul(x, w, scale, shift, *, act, out_dtype, ctx)   (M,K)@(K,N) -> (M,N)
      fused epilogue act((x @ w) * scale + shift), scale/shift (N,) or None,
      fp32 accumulation.
  bmm(x, w, *, out_dtype, ctx)               (B,M,K)@(B,K,N) -> (B,M,N)
      batched GEMM, fp32 accumulation, no epilogue.
  conv2d(x, w, scale, shift, *, size, stride, pad, act, out_dtype, ctx)
      NHWC x, flattened (kh*kw*Cin, Cout) w, same fused epilogue: one
      engine invocation per conv+BN+act layer.
  attention(q, k, v, *, causal, sm_scale, kv_len, ctx)
      softmax(q k^T * sm_scale) v with fp32 softmax statistics, grouped KV:
      q (B,Sq,H,D), k/v (B,Skv,KV,D), query head h attends kv-head
      h // (H/KV), no caller-side broadcast.  kv_len (None | int | scalar
      or (B,) tensor) masks keys at/beyond the per-batch length, clamped to
      Skv; causal queries right-align against kv_len when given, else Skv;
      fully-masked rows return exact 0.  Output (B,Sq,H,D).  On `cuda`,
      decode-shaped dispatches (`kernel_ops.use_decode_formulation`) take
      the split-KV decode kernel, the rest the forward kernel.
  ssd(x, dt, A, B, C, *, chunk, init_state, ctx)
      the Mamba2 SSD scan in chunks of `chunk` rows: x (Bt,S,H,P), dt
      (Bt,S,H) fp32 after softplus, A (H,) fp32 negative, B / C (Bt,S,G,N)
      with head h reading group h // (H/G), init_state None or fp32
      (Bt,H,P,N).  h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = C_t·h_t.
      Returns (y (Bt,S,H,P) in x's dtype, final state (Bt,H,P,N) fp32).
      `ref` runs `kernels/ssd.py::ssd_scan_plain`, `eager` the JAX
      `models/ssm.py::ssd_chunked` formulation, `cuda` the kernel.  The JAX
      engine has no such op: its model runs the einsum form everywhere.
  einsum(spec, x, y, *, acc_dtype, out_dtype, ctx)
      a two-operand contraction, fp32 products, the result rounded to
      acc_dtype then cast to out_dtype (JAX's preferred_element_type).
      `ref` and `eager` run torch.einsum; `cuda` runs a spec that is a
      batched GEMM after a permutation (`bmm_spec`: the MoE expert GEMMs
      becd,edf->becf and becf,efd->becd) on the bmm kernel, and raises
      NotImplementedError naming any other spec.  The JAX engine's einsum
      is not a registry op; the port counts its dispatches as the others.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import warnings
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import autotune
from repro_torch.core.precision import Precision
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import gemm as gemm_kernel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.kernels.common import apply_act, im2col

OP_SET = ("matmul", "bmm", "conv2d", "attention", "ssd", "einsum")


@dataclasses.dataclass(frozen=True)
class OpContext:
    """Per-dispatch context handed to backend op implementations."""
    precision: Precision
    # The plan resolved from the autotune cache on tiled backends (a
    # `gemm.Plan` for GEMM-shaped ops, a `flash_attention.FwdPlan` for
    # attention), () otherwise.
    tiles: tuple = ()


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered execution target: op impls, optional autotune hooks,
    `differentiable`, the ops autograd may flow through, and an optional
    `inference_only(op, operands) -> bool` naming the dispatches of those
    ops that have no backward.

    `tile_picker(op, shapes, dtype) -> tuple` is the instant heuristic
    pick; `tile_candidates(op, shapes, dtype) -> [tuple, ...]` enumerates
    the plans the measure policy times, and `tile_bench(op, shapes, dtype,
    tiles) -> thunk | None` builds a zero-argument callable running one
    launch with those tiles.  A backend with only a picker autotunes
    heuristically; one with all three takes part in ``measure``.  The
    hooks get the dtype by its JAX name (``"float32"``)."""
    name: str
    ops: Mapping[str, Callable]
    tile_picker: Callable[[str, tuple, Any], tuple] | None = None
    tile_candidates: Callable[[str, tuple, Any], list] | None = None
    tile_bench: Callable[..., Callable | None] | None = None
    differentiable: frozenset = frozenset(OP_SET)
    inference_only: Callable[[str, tuple], bool] | None = None

    def supports_grad(self, op: str) -> bool:
        """Whether autograd may flow through this backend's `op`."""
        return op in self.differentiable

    def op(self, name: str) -> Callable:
        """The registered impl for `name`; NotImplementedError when this
        backend does not provide it."""
        try:
            return self.ops[name]
        except KeyError:
            raise NotImplementedError(
                f"backend {self.name!r} does not implement op {name!r} "
                f"(has: {sorted(self.ops)})") from None

    def tiles(self, op: str, shapes: tuple, dtype) -> tuple:
        """Plan for one dispatch, resolved through the autotune cache under
        the active policy (see `tile_plan`); () for an untiled backend."""
        if self.tile_picker is None:  # untiled backend: skip the cache
            return ()
        return tile_plan(op, shapes, dtype, self.name, self.tile_picker,
                         candidates=self.tile_candidates,
                         bench=self.tile_bench)


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, ops: Mapping[str, Callable], *,
                     tile_picker=None, tile_candidates=None, tile_bench=None,
                     differentiable=None, inference_only=None,
                     overwrite: bool = False) -> Backend:
    """Register a backend implementing (a subset of) OP_SET.

    `tile_picker` is the optional heuristic `(op, shapes, dtype) -> tuple`
    whose picks the process-wide autotune cache memoizes;
    `tile_candidates` / `tile_bench` are the optional measure-policy hooks
    (see `Backend`), ignored unless the policy is "measure".
    `differentiable` names the ops autograd may flow through; None means
    every registered op (right for backends of plain PyTorch ops).  A
    kernel backend names only the ops whose kernels have a backward, and
    `inference_only(op, operands)` may mark the dispatches of those that
    take a formulation without one.

    Raises ValueError on a duplicate name without `overwrite`, on op names
    outside OP_SET (typos fail at registration, not dispatch), and on a
    `differentiable` entry naming an unregistered op.
    """
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         "(pass overwrite=True to replace)")
    unknown = set(ops) - set(OP_SET)
    if unknown:
        raise ValueError(f"unknown ops {sorted(unknown)}; op set is {OP_SET}")
    diff = frozenset(ops if differentiable is None else differentiable)
    if not diff <= set(ops):
        raise ValueError(f"differentiable names unregistered ops "
                         f"{sorted(diff - set(ops))}; registered: "
                         f"{sorted(ops)}")
    be = Backend(name=name, ops=dict(ops), tile_picker=tile_picker,
                 tile_candidates=tile_candidates, tile_bench=tile_bench,
                 differentiable=diff, inference_only=inference_only)
    _REGISTRY[name] = be
    return be


def get_backend(name: str) -> Backend:
    """The registered `Backend` for `name`; ValueError naming the
    registered backends when unknown."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{list_backends()}") from None


def list_backends() -> tuple[str, ...]:
    """Sorted names of all registered backends."""
    return tuple(sorted(_REGISTRY))


def guard_grad(backend: Backend, op: str, *operands) -> None:
    """Raise NotImplementedError, naming the backend and the op, when `op`
    is dispatched with grad enabled on an operand that requires grad and
    `backend` does not declare `op` differentiable, or declares this
    dispatch inference only.  None and non-tensor operands are ignored.
    The engine calls it on every dispatch with all gradient-carrying
    operands, scale and shift included."""
    if not kernel_ops.needs_grad(*operands):
        return
    if (backend.supports_grad(op) and backend.inference_only is not None
            and backend.inference_only(op, operands)):
        raise NotImplementedError(
            f"op {op!r} on backend {backend.name!r} is differentiable, but "
            f"this dispatch ({[tuple(t.shape) for t in operands[:2]]}) "
            f"takes a formulation that is inference only and has no "
            f"backward.  Differentiate a training-shaped dispatch, or use "
            f"the 'eager' backend.")
    if not backend.supports_grad(op):
        raise NotImplementedError(
            f"op {op!r} on backend {backend.name!r} is not differentiable: "
            f"the backend declares differentiable="
            f"{sorted(backend.differentiable)}, which does not include "
            f"{op!r}.  Use a backend that supports grad for {op!r} (the "
            f"'eager' backend differentiates every registered op), or "
            f"register the backend with a differentiable {op!r}.")


# ------------------------------------------------------- autotune cache ---
# Plan picks are memoized process-wide, keyed on (op, shapes, dtype,
# backend), the dtype by its JAX name.  Under the default "heuristic"
# policy a miss runs the backend's picker; under "measure" a miss of a key
# that has two or more candidates first consults the per-device persisted
# table (core/autotune.py), and only when that also misses times the
# candidates and persists the winner.  A memoized pick serves every later
# lookup of its key whatever the policy, as in the JAX registry.  Stats and
# per-key records are observable so tests and the smoke run can assert the
# cache's behaviour and report heuristic against measured picks.

AUTOTUNE_POLICIES = ("off", "heuristic", "measure")

_TILE_CACHE: dict[tuple, tuple] = {}
_TILE_RECORDS: dict[tuple, dict] = {}
_TILE_STATS = collections.Counter()


def _policy_from_env(value: str | None) -> str:
    """Default policy from `REPRO_AUTOTUNE`.  A typo'd value must not
    silently degrade to heuristic behaviour (the persisted table would
    never be consulted), so it warns loudly before falling back."""
    if value is None or value in AUTOTUNE_POLICIES:
        return value or "heuristic"
    warnings.warn(f"ignoring invalid REPRO_AUTOTUNE={value!r}; "
                  f"choose from {AUTOTUNE_POLICIES}", stacklevel=2)
    return "heuristic"


_POLICY = _policy_from_env(os.environ.get("REPRO_AUTOTUNE"))


def set_autotune_policy(policy: str) -> str:
    """Set the process-wide autotune policy; returns the previous one.

      off       : call the backend picker every time, no cache, no disk.
      heuristic : memoized picker (the default).
      measure   : memoized; first sight of a key loads the per-device
                  persisted pick or times the candidate set and persists
                  the winner.

    Raises ValueError for a policy outside AUTOTUNE_POLICIES.
    """
    global _POLICY
    if policy not in AUTOTUNE_POLICIES:
        raise ValueError(f"unknown autotune policy {policy!r}; "
                         f"choose from {AUTOTUNE_POLICIES}")
    prev, _POLICY = _POLICY, policy
    return prev


def get_autotune_policy() -> str:
    """The active policy (env default: `REPRO_AUTOTUNE` or "heuristic")."""
    return _POLICY


@contextlib.contextmanager
def autotune_policy(policy: str):
    """Context manager scoping a policy change (used by
    `Network.compile(..., autotune=...)` for its build pass)."""
    prev = set_autotune_policy(policy)
    try:
        yield
    finally:
        set_autotune_policy(prev)


def dtype_name(dtype) -> str:
    """The JAX name of a dtype, as the keys carry it: ``torch.float32``
    -> ``"float32"``; a string passes through."""
    return str(dtype).removeprefix("torch.")


def _measure_plan(key: tuple, picker, candidates, bench) -> tuple | None:
    """Measured resolution of a cache miss: the persisted pick if the
    per-device table has one, else time the candidates and persist the
    winner.  None when the key has fewer than two candidates (nothing to
    choose: the decode's split count, a decode-shaped attention
    dispatch, a head dim with one plan) or nothing could be timed (no
    card); the key then takes the heuristic pick and never reads the
    table.  Raises RuntimeError, naming the key, when it would time inside
    an active CUDA graph capture."""
    op, shapes, dtype_str, backend = key
    cands = [tuple(c) for c in candidates(op, shapes, dtype_str)]
    if len(cands) < 2:
        return None
    ks = autotune.key_str(op, shapes, dtype_str, backend)
    rec = autotune.lookup(ks)
    if rec is not None and rec.get("pick"):
        _TILE_STATS["persisted"] += 1
        _TILE_RECORDS[key] = dict(rec, source="persisted")
        return tuple(rec["pick"])
    if autotune.capturing():
        raise RuntimeError(
            f"autotune would measure {ks} inside an active CUDA graph "
            f"capture; resolve the key before capturing (one uncaptured "
            f"run under the measure policy, or a persisted table)")
    base = tuple(picker(op, shapes, dtype_str))
    if base and base not in cands:
        cands.insert(0, base)
    timed = []
    for cand in cands:
        thunk = bench(op, shapes, dtype_str, cand)
        if thunk is None:
            continue
        timed.append((cand, autotune.time_thunk(thunk)))
    if not timed:
        return None
    plan, est_ms = min(timed, key=lambda t: t[1])
    _TILE_STATS["measured"] += 1
    record = {"pick": list(plan), "est_ms": est_ms,
              "candidates_timed": [[list(c), ms] for c, ms in timed],
              "source": "measured"}
    _TILE_RECORDS[key] = record
    autotune.store(ks, record)
    return plan


def tile_plan(op: str, shapes: tuple, dtype, backend: str,
              picker: Callable[[str, tuple, Any], tuple], *,
              candidates=None, bench=None) -> tuple:
    """Plan pick keyed on (op, shapes, dtype, backend), resolved under
    the active autotune policy (see `set_autotune_policy`).

    A persisted or measured pick is checked by `validate_tiles` before it
    is ever launched: one that is not an instantiated plan, or does not
    fit at the shape (a stale table, another version's), warns, naming
    the key, the pick and the problem, and the key takes the heuristic
    pick.  (The JAX registry launches such a pick and only warns; here a
    launcher refuses an uninstantiated plan, so a stale table would stop
    dispatch.)"""
    dtype_str = dtype_name(dtype)
    if _POLICY == "off":
        return tuple(picker(op, shapes, dtype_str))
    key = (op, shapes, dtype_str, backend)
    hit = _TILE_CACHE.get(key)
    if hit is not None:
        _TILE_STATS["hits"] += 1
        return hit
    _TILE_STATS["misses"] += 1
    plan = None
    if _POLICY == "measure" and candidates is not None and bench is not None:
        plan = _measure_plan(key, picker, candidates, bench)
    if plan is not None:
        problems = validate_tiles(op, shapes, dtype_str, plan)
        if problems:
            src = _TILE_RECORDS[key]["source"]
            warnings.warn(
                f"autotune pick {plan} for {autotune.key_str(*key)} ({src}) "
                f"fails kernel legality: {'; '.join(problems)}; taking the "
                f"heuristic pick", stacklevel=2)
            plan = None
    if plan is None:
        plan = tuple(picker(op, shapes, dtype_str))
        _TILE_RECORDS[key] = {"pick": list(plan), "est_ms": None,
                              "candidates_timed": [], "source": "heuristic"}
    _TILE_CACHE[key] = plan
    return plan


def validate_tiles(op: str, shapes: tuple, dtype, tiles: tuple) -> list[str]:
    """Static legality of a resolved plan for one dispatch problem.

    Args:
      op: registry op name, or the "gemm_bwd" / "attention_bwd" backward
        keys and the "attention_decode" formulation key.
      shapes: the op's key shapes (see `gemm_dims`,
        `kernel_ops.gemm_bwd_dims` and `kernel_ops.attention_dims`).
      dtype: operand dtype (a torch dtype or its JAX name).
      tiles: the resolved plan: a `gemm.Plan` for GEMM-shaped ops, a
        `gemm.BwdPlan` for "gemm_bwd", a `flash_attention.FwdPlan` /
        `BwdPlan` for attention, (n_splits, span) for the decode.  An
        empty plan is vacuously legal (untiled backend).

    Returns a list of human-readable problems (empty = legal): the plan is
    instantiated (`gemm.PLANS`, `gemm.BWD_PLANS`) and fits at the head dim
    (`flash_attention.plans_at` / `bwd_plans_at`, with their shared-memory
    sizes); the decode's split is `decode_splits`'.  Malformed shapes or
    plans (a corrupt persisted table) come back as a problem string, never
    an exception.
    """
    if not tiles:
        return []
    try:
        if op == "attention_decode":
            _, _, skv, _, kv, _ = kernel_ops.attention_dims(shapes)
            return kernel_ops.validate_attention_decode_tiles(
                skv, kv, tuple(tiles))
        if op in ("attention", "attention_bwd"):
            _, sq, skv, _, _, d = kernel_ops.attention_dims(shapes)
            return kernel_ops.validate_attention_tiles(
                sq, skv, d, dtype, tuple(tiles),
                bwd=(op == "attention_bwd"))
        if op == "gemm_bwd":
            _, rows, kdim, cols, _ = kernel_ops.gemm_bwd_dims(shapes)
            return kernel_ops.validate_gemm_tiles(rows, kdim, cols, dtype,
                                                  tuple(tiles), bwd=True)
        dims = gemm_dims(op, shapes)
        if dims is None:
            return []
        return kernel_ops.validate_gemm_tiles(*dims, dtype, tuple(tiles))
    except Exception as e:
        return [f"unparseable shapes/plan for op {op!r}: {e!r}"]


def cache_stats() -> dict[str, int]:
    """Counters for the plan cache: `hits`/`misses` are lookups,
    `measured`/`persisted` split the misses resolved by timing vs by the
    per-device disk table, `entries` is the resident cache size."""
    return {"hits": _TILE_STATS["hits"], "misses": _TILE_STATS["misses"],
            "measured": _TILE_STATS["measured"],
            "persisted": _TILE_STATS["persisted"],
            "entries": len(_TILE_CACHE)}


def autotune_report() -> dict[str, dict]:
    """Per-key autotune records resolved by this process, keyed by the
    canonical JSON key string: `{key: {pick, est_ms, candidates_timed,
    source}}` with source one of heuristic|measured|persisted."""
    return {autotune.key_str(*k): dict(rec)
            for k, rec in _TILE_RECORDS.items()}


def clear_tile_cache() -> None:
    """Reset the in-process cache, records and stats (not the disk table)."""
    _TILE_CACHE.clear()
    _TILE_RECORDS.clear()
    _TILE_STATS.clear()


# ------------------------------------------------------ dispatch counts ---
# Incremented by ComputeEngine on every dispatch.  PyTorch runs eagerly, so
# unlike the JAX package (which counts once per trace) every call counts; a
# snapshot diff around one forward is that forward's op plan
# (CompiledNetwork captures it from its build).  The bounded LOG keeps the
# per-dispatch detail (shapes, dtype, tile plan).

_DISPATCH = collections.Counter()
_DISPATCH_LOG: list[dict] = []
_DISPATCH_LOG_LIMIT = 65536
_LAST: list = [None]    # the newest dispatch's record, if logged


def record_dispatch(backend: str, op: str, shapes: tuple | None = None,
                    dtype=None, tiles: tuple = (), **extra) -> None:
    """Count one engine dispatch and append its detail record
    ``{backend, op, shapes, dtype, tiles}`` and any `extra` fields to the
    bounded log (oldest records win; past the limit only the counter
    advances)."""
    _DISPATCH[(backend, op)] += 1
    _LAST[0] = None
    if len(_DISPATCH_LOG) < _DISPATCH_LOG_LIMIT:
        _LAST[0] = {
            "backend": backend, "op": op, "shapes": shapes,
            "dtype": None if dtype is None else str(dtype),
            "tiles": tuple(tiles or ()), **extra}
        _DISPATCH_LOG.append(_LAST[0])


def differentiated(operands: tuple) -> tuple:
    """Which of a dispatch's operands autograd will differentiate, as a
    tuple of flags, or () when none will: grad is off, no operand
    requires it, or the dispatch runs inside a backward pass (the
    recompute of ``torch.utils.checkpoint``, whose graph is not
    differentiated again)."""
    if not torch.is_grad_enabled():
        return ()
    flags = tuple(isinstance(t, torch.Tensor) and t.requires_grad
                  for t in operands)
    if not any(flags) or torch._C._current_graph_task_id() != -1:
        return ()
    return flags


def dispatch_counts() -> dict[tuple[str, str], int]:
    return dict(_DISPATCH)


def last_dispatch() -> dict | None:
    """The record of the newest dispatch (the caller may add fields to
    it), or None when the log had no room for it."""
    return _LAST[0]


def dispatch_log() -> list[dict]:
    """Copy of the per-dispatch detail records (dispatch order)."""
    return list(_DISPATCH_LOG)


def dispatch_log_size() -> int:
    """Current log length: snapshot before a run, slice after."""
    return len(_DISPATCH_LOG)


def counts_since(snapshot: Mapping[tuple[str, str], int]
                 ) -> dict[tuple[str, str], int]:
    out = {k: v - snapshot.get(k, 0) for k, v in _DISPATCH.items()}
    return {k: v for k, v in out.items() if v}


def reset_dispatch_counts() -> None:
    """Clear the dispatch counters AND the detail log."""
    _DISPATCH.clear()
    _DISPATCH_LOG.clear()
    _LAST[0] = None


# --------------------------------------------------------- shared pieces ---

def im2col_conv2d(matmul_impl: Callable) -> Callable:
    """Build a conv2d op from a matmul op via materialized im2col: the
    paper's canonical conv lowering."""

    def conv2d(x, w, scale, shift, *, size, stride, pad, act, out_dtype,
               ctx):
        cols = im2col(x, size, size, stride, pad)     # (B, OH, OW, khkwC)
        b, oh, ow, _ = cols.shape
        y = matmul_impl(cols.reshape(b * oh * ow, -1), w, scale, shift,
                        act=act, out_dtype=out_dtype, ctx=ctx)
        return y.reshape(b, oh, ow, -1)

    return conv2d


def gemm_dims(op: str, shapes: tuple) -> tuple[int, int, int] | None:
    """The (m, k, n) GEMM an op's shapes run: conv2d maps to its im2col
    GEMM, bmm's (B, M, K, N) tile key or (M, K, N) dispatch key to one
    matrix's; None for ops without a GEMM-shaped tiling (attention plans
    by sequence: `kernel_ops.attention_dims`; "gemm_bwd":
    `kernel_ops.gemm_bwd_dims`)."""
    if op in ("matmul", "bmm"):
        return tuple(shapes[-3:])
    if op == "conv2d":
        (b, h, w, c), n, size, stride, pad = shapes
        oh = (h + 2 * pad - size) // stride + 1
        ow = (w + 2 * pad - size) // stride + 1
        return (b * oh * ow, size * size * c, n)
    return None


# ----------------------------------------------------------- ref backend ---

def _ref_matmul(x, w, scale, shift, *, act, out_dtype, ctx):
    return ref.matmul_ref(x, w, scale=scale, shift=shift, act=act,
                          out_dtype=out_dtype)


def _ref_bmm(x, w, *, out_dtype, ctx):
    return ref.bmm_ref(x, w, out_dtype=out_dtype)


def _ref_attention(q, k, v, *, causal, sm_scale, kv_len=None, ctx):
    return ref.flash_attention_ref(q, k, v, causal=causal,
                                   sm_scale=sm_scale, kv_len=kv_len)


def _ref_ssd(x, dt, A, B, C, *, chunk, init_state=None, ctx):
    return ssd_kernel.ssd_scan_plain(x, dt, dt * A, B, C, chunk=chunk,
                                     init_state=init_state)


def _torch_einsum(spec, x, y, *, acc_dtype, out_dtype, ctx):
    # fp32 products and sums (bf16 operands widen exactly), rounded to
    # acc_dtype as JAX's preferred_element_type, then cast to out_dtype.
    return torch.einsum(spec, x.float(), y.float()).to(acc_dtype).to(
        out_dtype)


# --------------------------------------------------------- eager backend ---

def _eager_matmul(x, w, scale, shift, *, act, out_dtype, ctx):
    # Same math as the kernel in PyTorch ops.  Emission dtype =
    # precision.reduce_dtype: f32 under fp32_strict, bf16 under mixed, as
    # the JAX `xla` backend.
    rdt = ctx.precision.reduce_dtype
    acc = torch.matmul(x, w).to(rdt)
    if scale is not None:
        acc = acc * scale.to(rdt)
    if shift is not None:
        acc = acc + shift.to(rdt)
    return apply_act(acc, act).to(out_dtype)


def _eager_bmm(x, w, *, out_dtype, ctx):
    # The JAX `xla` formulation: fp32 products (bf16 operands widen
    # exactly) and fp32 accumulation, cast to out_dtype.
    return torch.bmm(x.float(), w.float()).to(out_dtype)


def _eager_attention(q, k, v, *, causal, sm_scale, kv_len=None, ctx):
    # The JAX `xla` formulation: the G query heads sharing a kv-head are
    # folded into the query-sequence axis, (B, KV, G*Sq, D) against
    # (B, KV, Skv, D), so K / V are read once per group and never
    # broadcast.  fp32 scores and softmax; fully-masked rows exact 0.
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qf = (q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)
          .reshape(b, kvh, g * sq, d).float())
    kt = k.transpose(1, 2).float()                        # (B, KV, Skv, D)
    vt = v.transpose(1, 2).float()
    s = torch.matmul(qf, kt.transpose(-1, -2)) * sm_scale
    mask = ref.attention_mask(b, sq, skv, causal=causal, kv_len=kv_len,
                              device=q.device)
    maskf = mask[:, None].expand(-1, g, sq, skv).reshape(-1, g * sq, skv)
    s = s.masked_fill(~maskf[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(maskf.any(-1)[:, None, :, None], p, 0.0)
    o = torch.matmul(p, vt)                               # (B, KV, G*Sq, D)
    return (o.reshape(b, kvh, g, sq, d).permute(0, 3, 1, 2, 4)
            .reshape(b, sq, h, d).to(q.dtype))


def _eager_ssd(x, dt, A, Bm, Cm, *, chunk, init_state=None, ctx):
    # The JAX `models/ssm.py::ssd_chunked` formulation (its `xla` path):
    # the ragged tail padded with dt = 0 rows (exact), per-chunk decay
    # matrices exp(segsum(dA)), the intra-chunk GEMM term, per-chunk input
    # states, a short recurrence over the chunk states and the carried
    # state's term.  Heads are folded as (G, H/G) instead of repeating B
    # and C to every head: the same products, no broadcast copy.
    b, s_orig, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    s = -(-s_orig // chunk) * chunk
    if s != s_orig:
        pad = s - s_orig
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = s // chunk
    xdt = (x.float() * dt.float()[..., None]).reshape(b, nc, chunk, g, rep,
                                                      p)
    da = (dt.float() * A.float()).reshape(b, nc, chunk, h).movedim(-1, 2)
    cs = torch.cumsum(da, dim=-1)                         # (b, nc, H, Q)
    bc = Bm.float().reshape(b, nc, chunk, g, n)
    cc = Cm.float().reshape(b, nc, chunk, g, n)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal, cs[..., :, None] - cs[..., None, :],
                      float("-inf"))
    decay = torch.exp(seg).reshape(b, nc, g, rep, chunk, chunk)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    y_diag = torch.einsum("bcgrqk,bckgrp->bcqgrp", scores[:, :, :, None]
                          * decay, xdt)
    decay_in = torch.exp(cs[..., -1:] - cs).reshape(b, nc, g, rep, chunk)
    states = torch.einsum("bckgn,bcgrk,bckgrp->bcgrpn", bc, decay_in, xdt)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):                                   # the short scan
        prev.append(state)
        state = (torch.exp(cs[:, c, :, -1])[..., None, None] * state
                 + states[:, c].reshape(b, h, p, n))
    prev = torch.stack(prev, dim=1).reshape(b, nc, g, rep, p, n)
    y_off = torch.einsum("bcqgn,bcgrq,bcgrpn->bcqgrp", cc,
                         torch.exp(cs).reshape(b, nc, g, rep, chunk), prev)
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), state


# ---------------------------------------------------------- cuda backend ---

def _cuda_matmul(x, w, scale, shift, *, act, out_dtype, ctx):
    if x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got x on "
                         f"{x.device}; use backend 'eager' on the CPU")
    return kernel_ops.matmul(x, w, scale, shift, act=act,
                             out_dtype=out_dtype, tiles=ctx.tiles)


def _cuda_bmm(x, w, *, out_dtype, ctx):
    if x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got x on "
                         f"{x.device}; use backend 'eager' on the CPU")
    return kernel_ops.bmm(x, w, out_dtype=out_dtype, tiles=ctx.tiles)


def _cuda_attention(q, k, v, *, causal, sm_scale, kv_len=None, ctx):
    # A decode-shaped dispatch takes the split-KV kernel, whose split count
    # resolves under its own "attention_decode" key inside the wrapper;
    # ctx.tiles is the forward's plan, () for such a dispatch.
    if q.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got q on "
                         f"{q.device}; use backend 'eager' on the CPU")
    if kernel_ops.use_decode_formulation(q.shape[1], k.shape[1]):
        return kernel_ops.attention_decode(q, k, v, kv_len, sm_scale,
                                           causal=causal)
    return kernel_ops.attention(q, k, v, kv_len, sm_scale, causal=causal,
                                plan=ctx.tiles)


def kernel_or_einsum_ssd(x, dt, A, B, C, *, chunk, init_state=None, ctx):
    """The SSD op of the kernel backends (`cuda`, `sharded_cuda`): under
    grad the JAX package's own training form, `_eager_ssd` (the
    `ssd_chunked` einsums, which autograd differentiates), counted in
    `ssd.einsum_dispatches`; without grad the SSD kernel.  The choice
    follows grad mode only, never a failure."""
    if kernel_ops.needs_grad(x, dt, A, B, C, init_state):
        ssd_kernel.einsum_dispatches += 1
        return _eager_ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state,
                          ctx=ctx)
    return kernel_ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)


def _cuda_ssd(x, dt, A, B, C, *, chunk, init_state=None, ctx):
    if x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got x on "
                         f"{x.device}; use backend 'eager' on the CPU")
    return kernel_or_einsum_ssd(x, dt, A, B, C, chunk=chunk,
                                init_state=init_state, ctx=ctx)


def bmm_spec(spec: str) -> tuple[str, str, str, str, str] | None:
    """The batched GEMM an einsum spec is after a permutation, or None.

    A spec ``x,y->z`` is one when y has three distinct indices, in any
    order: a batch index e (in x and z), a contraction index k (in x, not
    in z) and an output column n (not in x); x holds e, k and its row
    indices (none of them in y), and z is x with k replaced by n.  Returns
    (x, y, z, the x order (e, rows..., k), the y order (e, k, n)); e.g.
    ``becd,edf->becf`` gives x order ``ebcd`` and y order ``edf``: (E,
    B·C, D) @ (E, D, F); MLA's absorbed ``bqhn,rhn->bqhr`` gives ``hbqn``
    and ``hnr``: (H, B·Q, N) @ (H, N, R), y read from its (R, H, N)
    layout."""
    try:
        lhs, z = spec.replace(" ", "").split("->")
        x, y = lhs.split(",")
    except ValueError:
        return None
    if len(y) != 3 or len(set(y)) != 3 or len(set(x)) != len(x):
        return None
    batch = [c for c in y if c in x and c in z]
    contract = [c for c in y if c in x and c not in z]
    col = [c for c in y if c not in x]
    if not len(batch) == len(contract) == len(col) == 1:
        return None
    e, k, n = batch[0], contract[0], col[0]
    rows = [c for c in x if c not in (e, k)]
    if not rows or z != x.replace(k, n):
        return None
    return x, y, z, e + "".join(rows) + k, e + k + n


def einsum_as_bmm(spec, x, y, *, acc_dtype, out_dtype):
    """The `cuda` backend's einsum: a spec that is a batched GEMM after a
    permutation (`bmm_spec`) as x permuted to (E, rows..., K) and folded
    to (E, M, K), times y permuted to (E, K, N) on `kernels.ops.bmm` (the
    bmm kernel, which reads row-major operands: a y that is not in that
    order already is copied, 4 MB a call at deepseek-v2-lite's absorbed
    W_uk / W_uv; its plain version for CPU tensors), the rows unfolded
    and z's index order restored (a view, no copy).  NotImplementedError
    names any other spec: there is no kernel for it."""
    form = bmm_spec(spec)
    if form is None:
        raise NotImplementedError(
            f"backend 'cuda' runs einsum {spec!r} on no kernel: it runs "
            f"only specs that are a batched GEMM after a permutation (the "
            f"MoE expert GEMMs, e.g. 'becd,edf->becf', MLA's absorbed "
            f"'bqhn,rhn->bqhr')")
    xs, ys, zs, order, yorder = form
    xp = x.permute(*[xs.index(c) for c in order])
    yp = y.permute(*[ys.index(c) for c in yorder])
    e, *rows, kdim = xp.shape
    out = kernel_ops.bmm(xp.reshape(e, -1, kdim), yp, out_dtype=acc_dtype)
    out = out.reshape(e, *rows, yp.shape[2])
    zorder = order[:-1] + yorder[2]
    return out.permute(*[zorder.index(c) for c in zs]).to(out_dtype)


def _cuda_einsum(spec, x, y, *, acc_dtype, out_dtype, ctx):
    if x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got x on "
                         f"{x.device}; use backend 'eager' on the CPU")
    return einsum_as_bmm(spec, x, y, acc_dtype=acc_dtype,
                         out_dtype=out_dtype)


def decode_inference_only(op: str, operands: tuple) -> bool:
    """The `inference_only` hook of the kernel backends (`cuda`,
    `sharded_cuda`): a decode-shaped attention dispatch takes the split-KV
    kernel (or the sequence split's partials), which has no backward."""
    return op == "attention" and kernel_ops.use_decode_formulation(
        operands[0].shape[1], operands[1].shape[1])


def _cuda_tile_picker(op: str, shapes: tuple, dtype) -> tuple:
    """The `cuda` backend's heuristic pick: the shape rules of today's
    kernels (the JAX `_pallas_tile_picker`'s counterpart)."""
    if op in ("attention", "attention_bwd", "attention_decode"):
        b, sq, skv, h, kv, d = kernel_ops.attention_dims(shapes)
        if op == "attention_decode":
            return kernel_ops.decode_splits(skv, kv)
        if op == "attention_bwd":
            return flash_kernel.bwd_plan_for(b, sq, h, kv, d)
        if kernel_ops.use_decode_formulation(sq, skv):
            return ()  # the split-KV kernel: see "attention_decode"
        return flash_kernel.plan_for(b, sq, h, kv, d)
    if op == "gemm_bwd":
        variant, rows, kdim, cols, batch = kernel_ops.gemm_bwd_dims(shapes)
        return gemm_kernel.bwd_plan_for(variant, rows, kdim, cols, batch)
    dims = gemm_dims(op, shapes)
    if op == "bmm":
        return kernel_ops.bmm_plan_for(*dims)
    return () if dims is None else kernel_ops.default_tiles(*dims)


def _cuda_tile_candidates(op: str, shapes: tuple, dtype) -> list:
    """Every instantiated plan the key's kernel admits, the heuristic pick
    first; none for the decode's split count and for ops without plans."""
    if op == "attention":
        return kernel_ops.candidate_attention_blocks(
            *kernel_ops.attention_dims(shapes), dtype)
    if op == "attention_bwd":
        return kernel_ops.candidate_attention_bwd_blocks(
            *kernel_ops.attention_dims(shapes), dtype)
    if op == "gemm_bwd":
        variant, rows, kdim, cols, batch = kernel_ops.gemm_bwd_dims(shapes)
        return kernel_ops.candidate_gemm_bwd_blocks(variant, rows, kdim,
                                                    cols, dtype, batch)
    dims = gemm_dims(op, shapes)
    if dims is None:
        return []
    return kernel_ops.candidate_blocks(op, *dims, dtype)


def _cuda_tile_bench(op: str, shapes: tuple, dtype, tiles: tuple):
    """One launch of the key's kernel under `tiles` on zero operands of
    the key's shape on the current CUDA device (None without a card)."""
    if op == "attention":
        return kernel_ops.attention_bench_thunk(
            *kernel_ops.attention_dims(shapes), dtype, tiles)
    if op == "attention_bwd":
        return kernel_ops.attention_bwd_bench_thunk(
            *kernel_ops.attention_dims(shapes), dtype, tiles)
    if op == "gemm_bwd":
        _, rows, kdim, cols, batch = kernel_ops.gemm_bwd_dims(shapes)
        return kernel_ops.gemm_bwd_bench_thunk(shapes[0], rows, kdim, cols,
                                               dtype, tiles, batch)
    dims = gemm_dims(op, shapes)
    if dims is None:
        return None
    batch = shapes[0] if op == "bmm" and len(shapes) == 4 else 1
    return kernel_ops.bench_thunk(op, *dims, dtype, tiles, batch)


register_backend("ref", {
    "matmul": _ref_matmul,
    "bmm": _ref_bmm,
    "conv2d": im2col_conv2d(_ref_matmul),
    "attention": _ref_attention,
    "ssd": _ref_ssd,
    "einsum": _torch_einsum,
})

register_backend("eager", {
    "matmul": _eager_matmul,
    "bmm": _eager_bmm,
    "conv2d": im2col_conv2d(_eager_matmul),
    "attention": _eager_attention,
    "ssd": _eager_ssd,
    "einsum": _torch_einsum,
})

register_backend("cuda", {
    "matmul": _cuda_matmul,
    "bmm": _cuda_bmm,
    "conv2d": im2col_conv2d(_cuda_matmul),
    "attention": _cuda_attention,
    "ssd": _cuda_ssd,
    "einsum": _cuda_einsum,
}, tile_picker=_cuda_tile_picker, tile_candidates=_cuda_tile_candidates,
    tile_bench=_cuda_tile_bench, inference_only=decode_inference_only)
