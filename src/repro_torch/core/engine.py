"""ComputeEngine: the paper's contribution as a PyTorch module (port of
``repro/core/engine.py``).

Every dense computation of the Darknet path (conv layers via im2col, the
connected layers, the deconv GEMM), of the dense LM (every projection,
the LM head, attention) and of the Mamba2 SSM (every projection, the head,
the SSD scan) routes through this engine, and so do the batched GEMM
(`bmm`) and the MoE expert contractions (`einsum`).  The engine
is a thin dispatcher: each op resolves through the backend/op registry
(core/backends.py), so adding an execution target is `register_backend` and
no engine change.  Built-in backends: `cuda` (the hand-written Hopper
kernel, the default), `eager` (PyTorch formulations, the CPU path) and `ref`
(plain oracles).

The card is the default: `make_engine()` is the `cuda` backend on
``device="cuda"`` and raises when there is no GPU; the CPU is used only when
the caller asks for it (``make_engine("eager", device="cpu")``).

The engine is a frozen dataclass, so it is hashable and can key caches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import scopes
from repro_torch.core import backends
from repro_torch.core.precision import Precision
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ssd as ssd_kernel


@dataclasses.dataclass(frozen=True)
class ComputeEngine:
    backend: str = "cuda"
    precision: Precision = Precision("fp32_strict")
    # Where the network's parameters and activations live.
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        # A bare "cuda" gets its index, so it compares equal to the device
        # of the tensors made on it.
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_available() else 0)
        object.__setattr__(self, "device", dev)

    # ---------------------------------------------------------- dispatch ---
    def _resolve(self, op: str, shapes: tuple, dtype,
                 tile_shapes: tuple | None = None,
                 operands: tuple = ()) -> backends.OpContext:
        """Look up the backend's plan through the autotune cache (under
        `tile_shapes` where the plan's key differs from the dispatch's:
        bmm's carries the batch) and count the dispatch (with its shapes,
        dtype and plan in the dispatch log; a bmm's record adds its
        ``batch``, a differentiated dispatch's its ``grad`` flags:
        `backends.differentiated(operands)`)."""
        tiles = backends.get_backend(self.backend).tiles(
            op, shapes if tile_shapes is None else tile_shapes, dtype)
        extra = {"batch": tile_shapes[0]} if op == "bmm" else {}
        grad = backends.differentiated(operands)
        if grad:
            extra["grad"] = grad
        backends.record_dispatch(self.backend, op, shapes=shapes,
                                 dtype=dtype, tiles=tiles, **extra)
        return backends.OpContext(precision=self.precision, tiles=tiles)

    def _op(self, op: str):
        return backends.get_backend(self.backend).op(op)

    def _call(self, op: str, *args, **kwargs):
        """Run the backend's `op` on the dispatch `_resolve` just logged,
        under ``named_scope(op_scope(op))`` (the JAX engine's
        ``jax.named_scope``), telling any trace recorder its operands and
        results (`named_scope.boundary`).
        A dispatch that raises instead of returning is marked ``cut`` in
        its log record: the recompute of ``torch.utils.checkpoint`` stops
        inside the last dispatch of a region whose saved tensors it needs,
        and that dispatch's remaining work (the sharded backend's output
        gather, kernels/sharded.py) never runs."""
        record = backends.last_dispatch()
        with backends.named_scope(backends.op_scope(op)) as scope:
            try:
                out = self._op(op)(*args, **kwargs)
            except BaseException:
                if record is not None:
                    record["cut"] = True
                raise
            if scopes.OBSERVERS:
                scope.boundary(op, args, out)
        return out

    def _guard(self, op: str, *operands) -> None:
        """The autodiff capability check (`backends.guard_grad`): an op the
        backend does not declare differentiable raises a clear
        NotImplementedError when dispatched with grad enabled on an
        operand that requires grad."""
        backends.guard_grad(backends.get_backend(self.backend), op,
                            *operands)

    # --------------------------------------------------------------- ops ---
    def matmul(self, x, w, *, scale=None, shift=None, act: str = "linear",
               out_dtype=None):
        """act((x @ w) * scale + shift) over the last dim of x.

        Args:
          x: (..., K) input; leading dims are flattened for the kernel and
            restored on the result.
          w: (K, N) weight.
          scale, shift: (N,) epilogue vectors or None (folded BN / bias).
          act: activation name understood by `kernels.common.apply_act`.
          out_dtype: result dtype; defaults to the policy compute dtype.

        Returns (..., N) with fp32 accumulation regardless of out_dtype.
        Raises NotImplementedError when the backend lacks the op, or when
        it is differentiated and the backend does not declare it
        differentiable.
        """
        *lead, k = x.shape
        n = w.shape[-1]
        out_dtype = out_dtype or self.precision.compute_dtype
        xc = x.to(self.precision.compute_dtype).reshape(-1, k)
        wc = w.to(self.precision.compute_dtype)
        self._guard("matmul", xc, wc, scale, shift)
        ctx = self._resolve("matmul", (xc.shape[0], k, n), xc.dtype,
                            operands=(xc, wc, scale, shift))
        y = self._call("matmul", xc, wc, scale, shift, act=act,
                       out_dtype=out_dtype, ctx=ctx)
        return y.reshape(*lead, n)

    def bmm(self, x, w, *, out_dtype=None):
        """Batched GEMM (B, M, K) @ (B, K, N), fp32 accumulation.

        Both operands run in the compute dtype.  Returns (B, M, N) in
        `out_dtype` (default: x's dtype).  Raises ValueError on operands
        that are not (B, M, K) and (B, K, N); NotImplementedError when the
        backend lacks the op, or when it is differentiated and the backend
        does not declare it differentiable.
        """
        kernel_ops.validate_bmm_shapes(x, w)
        b, m, k = x.shape
        n = w.shape[-1]
        out_dtype = out_dtype or x.dtype
        xc = x.to(self.precision.compute_dtype)
        wc = w.to(self.precision.compute_dtype)
        self._guard("bmm", xc, wc)
        ctx = self._resolve("bmm", (m, k, n), xc.dtype,
                            tile_shapes=(b, m, k, n), operands=(xc, wc))
        return self._call("bmm", xc, wc, out_dtype=out_dtype, ctx=ctx)

    def conv2d(self, x, w, *, scale=None, shift=None, size: int,
               stride: int = 1, pad: int = 0, act: str = "linear",
               out_dtype=None):
        """Fused conv+BN+activation as ONE engine invocation.

        Args:
          x: (B, H, W, Cin) NHWC input.
          w: (kh*kw*Cin, Cout) flattened HWIO weight.
          scale, shift: (Cout,) or None (folded batch-norm / bias epilogue).
          size, stride, pad: square kernel size, stride, symmetric padding.
          act: activation name; out_dtype defaults to the compute dtype.

        Returns (B, OH, OW, Cout).  Raises NotImplementedError when the
        backend lacks the op, or when it is differentiated and the backend
        does not declare it differentiable.
        """
        out_dtype = out_dtype or self.precision.compute_dtype
        xc = x.to(self.precision.compute_dtype)
        wc = w.to(self.precision.compute_dtype)
        self._guard("conv2d", xc, wc, scale, shift)
        ctx = self._resolve(
            "conv2d", (tuple(xc.shape), wc.shape[-1], size, stride, pad),
            xc.dtype, operands=(xc, wc, scale, shift))
        return self._call("conv2d", xc, wc, scale, shift, size=size,
                                  stride=stride, pad=pad, act=act,
                                  out_dtype=out_dtype, ctx=ctx)

    def attention(self, q, k, v, *, causal: bool = True, sm_scale=None,
                  kv_len=None):
        """softmax(q k^T / sqrt(D)) v, fp32 softmax statistics, grouped KV.

        Args:
          q: (B, Sq, H, D) queries.
          k, v: (B, Skv, KV, D) with KV <= H and H % KV == 0, the compact
            grouped layout: query head h attends kv-head h // (H/KV) and no
            caller-side broadcast happens.  KV == H is plain MHA.
          causal: queries right-align against the live key extent, Skv or
            kv_len when given (a prefill chunk into a larger cache keeps
            causality between its own tokens).  Sq <= Skv is required.
          sm_scale: softmax scale, a float or a tensor; default 1/sqrt(D).
          kv_len: None, an int, or a scalar or (B,) int tensor: keys at
            positions >= kv_len are masked per batch row; values above Skv
            clamp to Skv.  Rows with no live key return exact 0.

        Returns (B, Sq, H, D) in the compute dtype.  Raises ValueError on a
        non-dividing head ratio, mismatched shapes or dtypes, causal with
        Sq > Skv, or a mis-shaped kv_len; NotImplementedError when it is
        differentiated on a backend whose attention is forward only
        (`cuda`).
        """
        kernel_ops.validate_attention_shapes(q, k, v)
        if causal and q.shape[1] > k.shape[1]:
            raise ValueError(
                f"causal attention requires Sq <= Skv (right-aligned "
                f"queries); got Sq={q.shape[1]}, Skv={k.shape[1]}")
        kernel_ops.validate_kv_len(kv_len, q.shape[0])
        dt = self.precision.compute_dtype
        qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
        self._guard("attention", qc, kc, vc, sm_scale)
        ctx = self._resolve("attention",
                            (tuple(qc.shape), tuple(kc.shape)), qc.dtype,
                            operands=(qc, kc, vc))
        return self._call("attention", qc, kc, vc, causal=causal,
                                     sm_scale=sm_scale, kv_len=kv_len,
                                     ctx=ctx)

    def ssd(self, x, dt, A, B, C, *, chunk: int, init_state=None):
        """The Mamba2 SSD scan (state-space duality) in chunks of `chunk`
        rows: h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = C_t · h_t.

        Args:
          x: (Bt, S, H, P) per-head inputs.
          dt: (Bt, S, H) step sizes, already softplus'ed.
          A: (H,) negative decay rates.
          B, C: (Bt, S, G, N) with H % G == 0: head h reads group
            h // (H / G), never broadcast by the caller.
          chunk: rows per chunk; any S (the ragged tail is exact).
          init_state: None (zeros) or (Bt, H, P, N), the state before row 0.

        x, B and C run in the compute dtype, dt, A and the state in fp32.
        Returns (y (Bt, S, H, P) in the compute dtype, final state
        (Bt, H, P, N) fp32).  Raises ValueError on mismatched shapes.
        Differentiated on `cuda`, it takes the einsum form the JAX package
        trains through, since the SSD kernel is inference only (as the JAX
        kernel).
        """
        cdt = self.precision.compute_dtype
        xc, bc, cc = x.to(cdt), B.to(cdt), C.to(cdt)
        dtf, af = dt.float(), A.float()
        init = None if init_state is None else init_state.float()
        ssd_kernel.check_operands(xc, dtf, bc, cc, chunk=chunk, A=af,
                                  init_state=init)
        self._guard("ssd", xc, dtf, af, bc, cc, init)
        ctx = self._resolve("ssd", (tuple(xc.shape), tuple(bc.shape), chunk),
                            xc.dtype, operands=(xc, dtf, af, bc, cc, init))
        return self._call("ssd", xc, dtf, af, bc, cc, chunk=chunk,
                               init_state=init, ctx=ctx)

    def einsum(self, spec: str, x, y, *, out_dtype=None,
               acc_dtype=torch.float32):
        """Precision-policy einsum of two operands, as the JAX engine's:
        both operands in the compute dtype, fp32 products, the result in
        `acc_dtype` (fp32 by default; the MoE expert GEMMs pass the
        policy's reduce_dtype), then `out_dtype` (default the compute
        dtype).

        On `ref` and `eager` any spec runs (torch.einsum).  On `cuda` a
        spec that is a batched GEMM after a permutation
        (`backends.bmm_spec`, e.g. ``becd,edf->becf``) runs on the bmm
        kernel; any other spec raises NotImplementedError naming it.
        Raises NotImplementedError, too, when it is differentiated on a
        backend that does not declare it differentiable.
        """
        out_dtype = out_dtype or self.precision.compute_dtype
        xc = x.to(self.precision.compute_dtype)
        yc = y.to(self.precision.compute_dtype)
        self._guard("einsum", xc, yc)
        ctx = self._resolve("einsum", (spec, tuple(xc.shape),
                                       tuple(yc.shape)), xc.dtype,
                            operands=(xc, yc))
        return self._call("einsum", spec, xc, yc, acc_dtype=acc_dtype,
                                  out_dtype=out_dtype, ctx=ctx)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_engine(backend: str = "cuda", policy: str = "fp32_strict",
                device: str | torch.device = "cuda") -> ComputeEngine:
    """An engine on `device` (the card by default).

    Turns TF32 off in PyTorch's CUDA matmuls and convolutions: neither
    precision policy uses it, and under fp32_strict the products must be
    true fp32.  Raises RuntimeError for a CUDA device when no GPU is
    available (it never drops to the CPU), ValueError for an unknown
    backend or for the `cuda` backend on a non-CUDA device.  The
    `sharded_cuda` backend takes a CPU device too: there its wrappers run
    their plain versions per shard.
    """
    backends.get_backend(backend)  # fail fast on unknown backends
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' with the 'eager' or 'ref' backend "
                           "to run on the CPU")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on a CUDA device, not "
                         f"{device}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ComputeEngine(backend=backend, precision=Precision(policy),
                         device=device)

