"""Backend/op registry for the compute engine (PyTorch port of
``repro/core/backends.py``).

The paper's claim is that ONE full-precision compute engine serves every
dense layer of a CNN (conv-as-im2col, FC, deconv).  This module is the
software form of that claim: a fixed op set (`OP_SET`), a
`register_backend` / `get_backend` API so execution targets plug in without
touching `ComputeEngine`, and dispatch counters plus a bounded dispatch log.

Built-in backends:

  ref    : the plain oracles of kernels/ref.py.
  eager  : PyTorch formulations with the same precision policy and the same
           fused epilogue; the counterpart of the JAX package's `xla`, and
           the path every module runs on the CPU.
  cuda   : the hand-written Hopper kernels (kernels/gemm.py).  It takes CUDA
           tensors only: given a CPU tensor it raises, it never falls back.

Each backend registers every op of `OP_SET`: `matmul`, `bmm`, `conv2d`,
`attention` and `ssd`.  Each backend declares which ops autograd may flow
through (`differentiable`, as the JAX registry's autodiff capability):
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
the split-KV decode kernel, which has no backward, as in the JAX package,
and every `ssd` dispatch takes the SSD chunk-scan kernel, which has none
either (the JAX kernel has no VJP).
The engine calls `guard_grad` on every dispatch, so an op that a backend
does not declare differentiable, or an inference-only dispatch, raises a
clear NotImplementedError when it is dispatched with grad enabled on an
operand that requires it.  The
measured autotune policy of the JAX registry is later work: the `cuda`
backend picks its tiles with fixed heuristics
(`kernels/ops.py::default_tiles`, `default_bwd_tiles`, `decode_splits`).

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
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.precision import Precision
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.kernels.common import apply_act, im2col

OP_SET = ("matmul", "bmm", "conv2d", "attention", "ssd")


@dataclasses.dataclass(frozen=True)
class OpContext:
    """Per-dispatch context handed to backend op implementations."""
    precision: Precision
    # (bm, bk, bn) for GEMM-shaped ops on tiled backends, () otherwise.
    tiles: tuple = ()


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered execution target: op impls, an optional
    `tile_picker(op, shapes, dtype) -> tuple` for tiled backends,
    `differentiable`, the ops autograd may flow through, and an optional
    `inference_only(op, operands) -> bool` naming the dispatches of those
    ops that have no backward."""
    name: str
    ops: Mapping[str, Callable]
    tile_picker: Callable[[str, tuple, Any], tuple] | None = None
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
        """Tile plan for one dispatch, () for an untiled backend."""
        if self.tile_picker is None:
            return ()
        return tuple(self.tile_picker(op, shapes, dtype))


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, ops: Mapping[str, Callable], *,
                     tile_picker=None, differentiable=None,
                     inference_only=None, overwrite: bool = False) -> Backend:
    """Register a backend implementing (a subset of) OP_SET.

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


# ------------------------------------------------------ dispatch counts ---
# Incremented by ComputeEngine on every dispatch.  PyTorch runs eagerly, so
# unlike the JAX package (which counts once per trace) every call counts; a
# snapshot diff around one forward is that forward's op plan
# (CompiledNetwork captures it from its build).  The bounded LOG keeps the
# per-dispatch detail (shapes, dtype, tile plan).

_DISPATCH = collections.Counter()
_DISPATCH_LOG: list[dict] = []
_DISPATCH_LOG_LIMIT = 65536


def record_dispatch(backend: str, op: str, shapes: tuple | None = None,
                    dtype=None, tiles: tuple = ()) -> None:
    """Count one engine dispatch and append its detail record
    ``{backend, op, shapes, dtype, tiles}`` to the bounded log (oldest
    records win; past the limit only the counter advances)."""
    _DISPATCH[(backend, op)] += 1
    if len(_DISPATCH_LOG) < _DISPATCH_LOG_LIMIT:
        _DISPATCH_LOG.append({
            "backend": backend, "op": op, "shapes": shapes,
            "dtype": None if dtype is None else str(dtype),
            "tiles": tuple(tiles or ())})


def dispatch_counts() -> dict[tuple[str, str], int]:
    return dict(_DISPATCH)


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
    GEMM; None for ops without a GEMM-shaped tiling."""
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
    if q.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got q on "
                         f"{q.device}; use backend 'eager' on the CPU")
    if kernel_ops.use_decode_formulation(q.shape[1], k.shape[1]):
        return kernel_ops.attention_decode(q, k, v, kv_len, sm_scale,
                                           causal=causal)
    return kernel_ops.attention(q, k, v, kv_len, sm_scale, causal=causal)


def _cuda_ssd(x, dt, A, B, C, *, chunk, init_state=None, ctx):
    if x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors, got x on "
                         f"{x.device}; use backend 'eager' on the CPU")
    return kernel_ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)


def _cuda_inference_only(op: str, operands: tuple) -> bool:
    """A decode-shaped attention dispatch takes the split-KV kernel, and
    every ssd dispatch the SSD kernel: neither has a backward."""
    if op == "ssd":
        return True
    return op == "attention" and kernel_ops.use_decode_formulation(
        operands[0].shape[1], operands[1].shape[1])


def _cuda_tile_picker(op: str, shapes: tuple, dtype) -> tuple:
    dims = gemm_dims(op, shapes)
    return () if dims is None else kernel_ops.default_tiles(*dims)


register_backend("ref", {
    "matmul": _ref_matmul,
    "bmm": _ref_bmm,
    "conv2d": im2col_conv2d(_ref_matmul),
    "attention": _ref_attention,
    "ssd": _ref_ssd,
})

register_backend("eager", {
    "matmul": _eager_matmul,
    "bmm": _eager_bmm,
    "conv2d": im2col_conv2d(_eager_matmul),
    "attention": _eager_attention,
    "ssd": _eager_ssd,
})

register_backend("cuda", {
    "matmul": _cuda_matmul,
    "bmm": _cuda_bmm,
    "conv2d": im2col_conv2d(_cuda_matmul),
    "attention": _cuda_attention,
    "ssd": _cuda_ssd,
}, tile_picker=_cuda_tile_picker, inference_only=_cuda_inference_only)
