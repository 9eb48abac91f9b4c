"""The paper's "Innovative Compute Engine" on Hopper: the fused GEMM
``y = act((x @ w) * scale + shift)``, forward and backward, and the
batched GEMM of the engine's ``bmm`` op.

Replaces ``repro/kernels/gemm.py``'s six TPU kernels: ``_gemm_kernel``
(launched by ``_gemm_forward``, with and without its training residuals),
``gemm_bwd_dx`` and ``gemm_bwd_dw``, and the batched ``_bmm_forward``,
``bmm_bwd_dx`` and ``bmm_bwd_dw``.  The kernels are hand-written CUDA C++
in ``csrc/gemm.cu`` and ``csrc/gemm_bwd.cu``, built by ``build.py`` into
libraries with a plain C interface and called through ctypes.  Each
source's header says what bounds it on the H100 (the fp32 FFMA rate:
under ``fp32_strict`` there are no tensor cores) and what its design does
about that.  A batched kernel is its 2-D kernel with the batch in the
grid: batch slice b has the bits of the 2-D launch on that slice.

Beside each kernel wrapper stands its plain PyTorch version:

  gemm_fused_fwd         forward; ``residuals=True`` also returns
                         g = act'(u) and the raw fp32 accumulator
  gemm_fused_plain       its plain version, without residuals
  gemm_fused_res_plain   its plain version, with residuals
  gemm_bwd_dx            dX = dY . W^T            (gemm_bwd_dx_plain)
  gemm_bwd_dw            dW = X^T . dY, split     (gemm_bwd_dw_plain)
                         contraction plus a reduce pass
  bmm_fwd                out[b] = x[b] @ w[b]     (bmm_fwd_plain)
  bmm_bwd_dx             dX[b] = dY[b] . W[b]^T   (bmm_bwd_dx_plain)
  bmm_bwd_dw             dW[b] = X[b]^T . dY[b]   (bmm_bwd_dw_plain)

A wrapper checks device, dtype, shape and contiguity, allocates its outputs
and workspace, and launches on PyTorch's current stream for a CUDA tensor;
only for a CPU tensor does it run the plain version instead.  A failed
build or launch raises; nothing falls back.  Each kernel has its own
launch count (`launches`, `launches_res`, `launches_dx`, `launches_dw`,
`launches_reduce`, `launches_bmm`, `launches_bmm_dx`, `launches_bmm_dw`),
moved only where the kernel is launched, so a run can show that its path
went through the kernels (`reset_launches`).

`GemmFused` is the ``torch.autograd.Function`` of ``jax.custom_vjp``
``_gemm``: its forward is the residual-emitting kernel, its backward the
epilogue's column sums in PyTorch and the two backward kernels.  It takes
a tied LM head's ``w = embed.t()`` in place, with no copy of the table:
the forward reads w transposed, dX = dY . E reads both operands as
stored, and dE = dY^T . X is `gemm_bwd_dw` with its operands swapped,
handed to autograd as its transpose.  `BmmFn` is the same for ``_bmm``:
the batched forward, then dX and dW by the batched backward kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (ACTIVATIONS, act_deriv, apply_act,
                                       epilogue)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILES = (64, 32)  # the square output tiles the kernels are instantiated for
BK = 16           # contraction depth of one stage; split chunks are whole stages

launches = 0         # gemm_fused_fwd, serving forward (no residuals)
launches_res = 0     # gemm_fused_fwd with residuals (the training forward)
launches_dx = 0      # gemm_bwd_dx
launches_dw = 0      # gemm_bwd_dw
launches_reduce = 0  # the split-contraction reduce pass of any of them
launches_bmm = 0     # bmm_fwd
launches_bmm_dx = 0  # bmm_bwd_dx
launches_bmm_dw = 0  # bmm_bwd_dw


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches, launches_res, launches_dx, launches_dw, launches_reduce
    global launches_bmm, launches_bmm_dx, launches_bmm_dw
    launches = launches_res = launches_dx = launches_dw = launches_reduce = 0
    launches_bmm = launches_bmm_dx = launches_bmm_dw = 0


def launch_counts() -> dict[str, int]:
    """The launch counts by kernel name."""
    return {"gemm_fused_fwd": launches, "gemm_fused_fwd_res": launches_res,
            "gemm_bwd_dx": launches_dx, "gemm_bwd_dw": launches_dw,
            "gemm_bwd_reduce": launches_reduce, "bmm_fwd": launches_bmm,
            "bmm_bwd_dx": launches_bmm_dx, "bmm_bwd_dw": launches_bmm_dw}


def gemm_fused_plain(x, w, scale=None, shift=None, *, act: str = "linear",
                     out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 products and fp32
    accumulation (TF32 off on the card), then the epilogue in fp32."""
    acc = torch.matmul(x.float(), w.float())
    return epilogue(acc, scale, shift, act).to(out_dtype or x.dtype)


def gemm_fused_res_plain(x, w, scale=None, shift=None, *,
                         act: str = "linear", out_dtype=None):
    """`gemm_fused_plain` with the training residuals: ``(y, g, racc)``,
    g = act'(u) in fp32 when act is not linear (else None) and racc = the
    fp32 x @ w when a scale is fused (else None)."""
    acc = torch.matmul(x.float(), w.float())
    u = epilogue(acc, scale, shift, "linear")
    y = apply_act(u, act).to(out_dtype or x.dtype)
    g = None if act == "linear" else act_deriv(u, act)
    return y, g, (acc if scale is not None else None)


def gemm_bwd_dx_plain(dy, w, *, out_dtype=None) -> torch.Tensor:
    """dX = dY . W^T for dy (M, N), w (K, N): fp32 products and sums."""
    return torch.matmul(dy.float(), w.float().t()).to(out_dtype or dy.dtype)


def gemm_bwd_dw_plain(x, dy, *, out_dtype=None) -> torch.Tensor:
    """dW = X^T . dY for x (M, K), dy (M, N): fp32 products and sums."""
    return torch.matmul(x.float().t(), dy.float()).to(out_dtype or x.dtype)


def bmm_fwd_plain(x, w, *, out_dtype=None) -> torch.Tensor:
    """out[b] = x[b] @ w[b] for x (B, M, K), w (B, K, N): fp32 products
    and sums (TF32 off on the card)."""
    return torch.bmm(x.float(), w.float()).to(out_dtype or x.dtype)


def bmm_bwd_dx_plain(dy, w, *, out_dtype=None) -> torch.Tensor:
    """dX[b] = dY[b] . W[b]^T for dy (B, M, N), w (B, K, N): fp32 products
    and sums."""
    return torch.bmm(dy.float(), w.float().transpose(1, 2)).to(
        out_dtype or dy.dtype)


def bmm_bwd_dw_plain(x, dy, *, out_dtype=None) -> torch.Tensor:
    """dW[b] = X[b]^T . dY[b] for x (B, M, K), dy (B, M, N): fp32 products
    and sums."""
    return torch.bmm(x.float().transpose(1, 2), dy.float()).to(
        out_dtype or x.dtype)


def _check(x, w, scale, shift, act, out_dtype):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    _check_dtypes(x, w, out_dtype)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {act!r}")
    n = w.shape[1]
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.shape != (n,) or v.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 ({n},); got "
                             f"{v.dtype} {tuple(v.shape)}")


def _check_dtypes(a, b, out_dtype):
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"operands must share float32 or bfloat16; got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def _check_cuda(name: str, tile: int, **tensors) -> None:
    """What every kernel takes: CUDA tensors on one device, contiguous,
    dimensions below 2**31, an instantiated tile."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {first.device}")
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    for key, v in tensors.items():
        if v is None:
            continue
        if v.device != first.device:
            raise ValueError(f"{key} is on {v.device}, {name}'s first "
                             f"operand on {first.device}")
        if not v.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
        if max(v.shape, default=0) >= 2**31:
            raise ValueError(f"{key} {tuple(v.shape)} is too large for the "
                             f"kernel")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # entry point -> (library, argument types before the stream)
    "gemm_fused_fwd": ("gemm", [_P] * 5 + [_I] * 8),
    "gemm_fused_fwd_res": ("gemm", [_P] * 7 + [_I] * 8),
    "gemm_bwd_dx": ("gemm_bwd", [_P] * 3 + [_I] * 8),
    "gemm_bwd_dw": ("gemm_bwd", [_P] * 3 + [_I] * 7),
    "gemm_bwd_reduce": ("gemm_bwd", [_P, _P, ctypes.c_longlong, _I, _I]),
    "bmm_fwd": ("gemm", [_P] * 3 + [_I] * 7),
    "bmm_bwd_dx": ("gemm_bwd", [_P] * 3 + [_I] * 8),
    "bmm_bwd_dw": ("gemm_bwd", [_P] * 3 + [_I] * 8),
}
# gridDim.z carries the batch (times the contraction split in the backward)
MAX_GRID_Z = 65535


def _launch(entry: str, device, *args, what: str) -> None:
    """Call a C entry point on PyTorch's current stream of `device`;
    RuntimeError with the CUDA error string when the launch fails."""
    lib, argtypes = _SIGNATURES[entry]
    build.launch(lib, entry, argtypes,
                 torch.cuda.current_stream(device).cuda_stream, *args,
                 what=what)


def _ptr(t):
    return None if t is None else t.data_ptr()


def is_transposed(w) -> bool:
    """Whether the 2-D `w` is not contiguous but its transpose is: a
    (K, N) view of a row-major (N, K) tensor, which the forward kernels
    and `gemm_bwd_dx` read in place."""
    return not w.is_contiguous() and w.t().is_contiguous()


def gemm_fused_fwd(x, w, scale=None, shift=None, *, act: str = "linear",
                   out_dtype=None, tile: int = 64, residuals: bool = False):
    """act((x @ w) * scale + shift) for x (M, K) and w (K, N).

    x is row-major.  w is row-major, or the transpose of a row-major
    (N, K) tensor (`is_transposed`: a tied LM head's ``embed.t()``), which
    the kernel reads in place with the same arithmetic, so the bits are
    those of a row-major copy.
    x and w share float32 or bfloat16; scale/shift are float32 (N,) or
    None; the result is (M, N) in `out_dtype` (default x.dtype), with fp32
    accumulation.  `tile` is the square output tile (one of `TILES`).
    With `residuals`, returns ``(y, g, racc)``: g = act'(u) fp32 (M, N)
    when act is not linear, racc = the fp32 accumulator x @ w when a scale
    is fused, each else None (``_gemm_forward(..., residuals=True)``); y
    has the same bits as without residuals.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    and raises RuntimeError if the launch fails.
    """
    out_dtype = out_dtype or x.dtype
    _check(x, w, scale, shift, act, out_dtype)
    if x.device.type == "cpu":
        plain = gemm_fused_res_plain if residuals else gemm_fused_plain
        return plain(x, w, scale, shift, act=act, out_dtype=out_dtype)
    trans_w = is_transposed(w)
    _check_cuda("gemm_fused_fwd", tile, x=x, w=w.t() if trans_w else w,
                scale=scale, shift=shift)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    g = racc = None
    if residuals:
        if act != "linear":
            g = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if scale is not None:
            racc = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        args = [_ptr(x), _ptr(w), _ptr(scale), _ptr(shift), _ptr(y)]
        if residuals:
            args += [_ptr(g), _ptr(racc)]
        args += [m, k, n, _DTYPES[x.dtype], _DTYPES[out_dtype],
                 ACTIVATIONS.index(act), tile, int(trans_w)]
        entry = "gemm_fused_fwd_res" if residuals else "gemm_fused_fwd"
        _launch(entry, x.device, *args, what=f"(M, K, N) = {(m, k, n)}")
        global launches, launches_res
        if residuals:
            launches_res += 1
        else:
            launches += 1
    return (y, g, racc) if residuals else y


def split_chunk(kdim: int, splits: int) -> tuple[int, int]:
    """(chunk, splits) for a contraction of `kdim` cut into at most
    `splits` pieces of whole BK stages; the returned split count is the
    number of non-empty pieces."""
    per_split = -(-kdim // max(1, splits))
    chunk = BK * max(1, -(-per_split // BK))
    return chunk, max(1, -(-kdim // chunk))


def _bwd(entry, a, b, dims, out_shape, kdim, out_dtype, tile, splits,
         *flags):
    """Launch the backward GEMM `entry` on operands a, b, with `dims` the
    entry point's sizes ((M, N, K) for dX, (M, K, N) for dW, each led by
    B for the batched entries), the entry's trailing `flags`, and the
    reduce pass when the contraction `kdim` is split; returns the output
    tensor.  A split's fp32 workspace is (splits, *out_shape), so the
    reduce adds the partials of every output, batch included, in split
    order."""
    global launches_dx, launches_dw, launches_reduce
    global launches_bmm_dx, launches_bmm_dw
    out = torch.empty(out_shape, dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    chunk, splits = split_chunk(kdim, splits)
    batch = out_shape[0] if len(out_shape) == 3 else 1
    if batch * splits > MAX_GRID_Z:
        raise ValueError(f"{entry}: batch {batch} x {splits} contraction "
                         f"splits exceeds the grid's {MAX_GRID_Z}")
    target = out if splits == 1 else torch.empty(
        (splits, *out_shape), dtype=torch.float32, device=a.device)
    what = f"sizes {dims}"
    _launch(entry, a.device, _ptr(a), _ptr(b), _ptr(target), *dims,
            _DTYPES[a.dtype], _DTYPES[target.dtype], tile, chunk, *flags,
            what=what)
    if entry == "gemm_bwd_dx":
        launches_dx += 1
    elif entry == "gemm_bwd_dw":
        launches_dw += 1
    elif entry == "bmm_bwd_dx":
        launches_bmm_dx += 1
    else:
        launches_bmm_dw += 1
    if splits > 1:
        _launch("gemm_bwd_reduce", a.device, _ptr(target), _ptr(out),
                out.numel(), splits, _DTYPES[out_dtype], what=what)
        launches_reduce += 1
    return out


def gemm_bwd_dx(dy, w, *, out_dtype=None, tile: int = 64,
                splits: int = 1) -> torch.Tensor:
    """dX[m, k] = sum_n dY[m, n] W[k, n] for dy (M, N), w (K, N) -> (M, K).

    w is row-major, or the transpose of a row-major (N, K) tensor (a tied
    LM head's ``embed.t()``), read in place: dX = dY . E is then a product
    of two row-major operands with the same fmaf chain over n, so the bits
    are those of a row-major copy of w.
    dy and w share float32 or bfloat16; fp32 accumulation; the result in
    `out_dtype` (default dy.dtype).  `splits` > 1 cuts the contraction
    into that many pieces (see `split_chunk`) whose fp32 partials a reduce
    pass adds in a fixed order.  A CPU tensor runs `gemm_bwd_dx_plain`; a
    CUDA tensor launches the kernel or raises.
    """
    out_dtype = out_dtype or dy.dtype
    if dy.dim() != 2 or w.dim() != 2 or dy.shape[1] != w.shape[1]:
        raise ValueError(f"need dy (M, N) and w (K, N); got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    _check_dtypes(dy, w, out_dtype)
    if dy.device.type == "cpu":
        return gemm_bwd_dx_plain(dy, w, out_dtype=out_dtype)
    trans_w = is_transposed(w)
    _check_cuda("gemm_bwd_dx", tile, dy=dy, w=w.t() if trans_w else w)
    (m, n), k = dy.shape, w.shape[0]
    return _bwd("gemm_bwd_dx", dy, w, (m, n, k), (m, k), n, out_dtype, tile,
                splits, int(trans_w))


def gemm_bwd_dw(x, dy, *, out_dtype=None, tile: int = 64,
                splits: int = 1) -> torch.Tensor:
    """dW[k, n] = sum_m X[m, k] dY[m, n] for x (M, K), dy (M, N) -> (K, N).

    As `gemm_bwd_dx`, with the contraction over M (the rows of the
    forward), which `splits` cuts; default out_dtype x.dtype.  A CPU
    tensor runs `gemm_bwd_dw_plain`.
    """
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"need x (M, K) and dy (M, N); got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    _check_dtypes(x, dy, out_dtype)
    if x.device.type == "cpu":
        return gemm_bwd_dw_plain(x, dy, out_dtype=out_dtype)
    _check_cuda("gemm_bwd_dw", tile, x=x, dy=dy)
    (m, k), n = x.shape, dy.shape[1]
    return _bwd("gemm_bwd_dw", x, dy, (m, k, n), (k, n), m, out_dtype, tile,
                splits)


class GemmFused(torch.autograd.Function):
    """The fused GEMM with its gradient (``repro``'s ``_gemm`` custom VJP).

    ``GemmFused.apply(x, w, scale, shift, act, out_dtype, tile, dx_plan,
    dw_plan)``; the plans are ``(tile, splits)`` of the two backward GEMMs
    (`kernels.ops.default_bwd_tiles`; for a transposed w, dw_plan is that
    of the swapped product dE = dY^T . X).  The forward saves x, w, scale and
    the residuals g and racc.  The backward, as ``_gemm_vjp_bwd``:
    dyg = dy * g; dshift = sum_rows dyg and dscale = sum_rows dyg * racc,
    in fp32 in PyTorch; dacc = dyg * scale cast to x's dtype; then dX and
    dW by the kernels.  dX is not computed when x needs no gradient (the
    network's first layer, whose input is the image).  For a transposed
    w (`is_transposed`, a tied head ``E.t()``) dW is computed as
    dE = dY^T . X, (N, K) like E, and returned as its transpose.
    """

    @staticmethod
    def forward(ctx, x, w, scale, shift, act, out_dtype, tile, dx_plan,
                dw_plan):
        y, g, racc = gemm_fused_fwd(x, w, scale, shift, act=act,
                                    out_dtype=out_dtype, tile=tile,
                                    residuals=True)
        ctx.save_for_backward(x, w, scale, g, racc)
        ctx.plans = (dx_plan, dw_plan)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, scale, g, racc = ctx.saved_tensors
        need_x, need_w, need_scale, need_shift = ctx.needs_input_grad[:4]
        (dx_tile, dx_splits), (dw_tile, dw_splits) = ctx.plans
        dyg = dy.float()                                   # dL/du
        if g is not None:
            dyg = dyg * g
        dshift = dyg.sum(0) if need_shift else None
        dscale = (dyg * racc).sum(0) if need_scale else None
        dacc = dyg * scale if scale is not None else dyg   # dL/d(x @ w)
        dacc = dacc.to(x.dtype).contiguous()
        dx = dw = None
        if need_x:
            dx = gemm_bwd_dx(dacc, w, out_dtype=x.dtype, tile=dx_tile,
                             splits=dx_splits)
        if need_w and is_transposed(w):
            dw = gemm_bwd_dw(dacc, x, out_dtype=w.dtype, tile=dw_tile,
                             splits=dw_splits).t()
        elif need_w:
            dw = gemm_bwd_dw(x, dacc, out_dtype=w.dtype, tile=dw_tile,
                             splits=dw_splits)
        return dx, dw, dscale, dshift, None, None, None, None, None


# ------------------------------------------------------------------- bmm ---

def _check_bmm(name, a, b, a_dims, b_dims, i, j, out_dtype):
    """Shape and dtype checks of a batched kernel's two operands: 3-D, the
    same batch, and the contraction a.shape[i] == b.shape[j]."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or (
            a.shape[i] != b.shape[j]):
        raise ValueError(f"{name} needs {a_dims} and {b_dims}; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    _check_dtypes(a, b, out_dtype)


def bmm_fwd(x, w, *, out_dtype=None, tile: int = 64) -> torch.Tensor:
    """out[b] = x[b] @ w[b] for x (B, M, K), w (B, K, N) -> (B, M, N).

    x and w are row-major and share float32 or bfloat16; fp32
    accumulation, no epilogue; the result in `out_dtype` (default
    x.dtype).  Slice b has the bits of `gemm_fused_fwd` (linear, no scale
    or shift) on x[b], w[b] at the same tile.  B is at most 65,535.  A CPU
    tensor runs `bmm_fwd_plain`; a CUDA tensor launches the kernel or
    raises.
    """
    out_dtype = out_dtype or x.dtype
    _check_bmm("bmm_fwd", x, w, "x (B, M, K)", "w (B, K, N)", 2, 1,
               out_dtype)
    if x.device.type == "cpu":
        return bmm_fwd_plain(x, w, out_dtype=out_dtype)
    _check_cuda("bmm_fwd", tile, x=x, w=w)
    (bsz, m, k), n = x.shape, w.shape[2]
    if bsz > MAX_GRID_Z:
        raise ValueError(f"bmm_fwd: batch {bsz} exceeds the grid's "
                         f"{MAX_GRID_Z}")
    y = torch.empty((bsz, m, n), dtype=out_dtype, device=x.device)
    if y.numel():
        _launch("bmm_fwd", x.device, _ptr(x), _ptr(w), _ptr(y), bsz, m, k, n,
                _DTYPES[x.dtype], _DTYPES[out_dtype], tile,
                what=f"(B, M, K, N) = {(bsz, m, k, n)}")
        global launches_bmm
        launches_bmm += 1
    return y


def bmm_bwd_dx(dy, w, *, out_dtype=None, tile: int = 64,
               splits: int = 1) -> torch.Tensor:
    """dX[b] = dY[b] . W[b]^T for dy (B, M, N), w (B, K, N) -> (B, M, K).

    As `gemm_bwd_dx` per batch slice (row-major w only), with the same
    bits at the same (tile, splits); B times the split count is at most
    65,535.  A CPU tensor runs `bmm_bwd_dx_plain`.
    """
    out_dtype = out_dtype or dy.dtype
    _check_bmm("bmm_bwd_dx", dy, w, "dy (B, M, N)", "w (B, K, N)", 2, 2,
               out_dtype)
    if dy.device.type == "cpu":
        return bmm_bwd_dx_plain(dy, w, out_dtype=out_dtype)
    _check_cuda("bmm_bwd_dx", tile, dy=dy, w=w)
    (bsz, m, n), k = dy.shape, w.shape[1]
    return _bwd("bmm_bwd_dx", dy, w, (bsz, m, n, k), (bsz, m, k), n,
                out_dtype, tile, splits)


def bmm_bwd_dw(x, dy, *, out_dtype=None, tile: int = 64,
               splits: int = 1) -> torch.Tensor:
    """dW[b] = X[b]^T . dY[b] for x (B, M, K), dy (B, M, N) -> (B, K, N).

    As `gemm_bwd_dw` per batch slice, with the same bits at the same
    (tile, splits); default out_dtype x.dtype.  A CPU tensor runs
    `bmm_bwd_dw_plain`.
    """
    out_dtype = out_dtype or x.dtype
    _check_bmm("bmm_bwd_dw", x, dy, "x (B, M, K)", "dy (B, M, N)", 1, 1,
               out_dtype)
    if x.device.type == "cpu":
        return bmm_bwd_dw_plain(x, dy, out_dtype=out_dtype)
    _check_cuda("bmm_bwd_dw", tile, x=x, dy=dy)
    (bsz, m, k), n = x.shape, dy.shape[2]
    return _bwd("bmm_bwd_dw", x, dy, (bsz, m, k, n), (bsz, k, n), m,
                out_dtype, tile, splits)


class BmmFn(torch.autograd.Function):
    """The batched GEMM with its gradient (``repro``'s ``_bmm`` custom VJP).

    ``BmmFn.apply(x, w, out_dtype, tile, dx_plan, dw_plan)``; the plans are
    ``(tile, splits)`` of the two backward kernels
    (`kernels.ops.default_bwd_tiles` with the batch).  The forward saves x
    and w.  The backward, as ``_bmm_vjp_bwd``: dy cast to x's dtype, then
    dX by `bmm_bwd_dx` in x's dtype and dW by `bmm_bwd_dw` in w's dtype,
    each only when its input needs a gradient.
    """

    @staticmethod
    def forward(ctx, x, w, out_dtype, tile, dx_plan, dw_plan):
        ctx.save_for_backward(x, w)
        ctx.plans = (dx_plan, dw_plan)
        return bmm_fwd(x, w, out_dtype=out_dtype, tile=tile)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        (dx_tile, dx_splits), (dw_tile, dw_splits) = ctx.plans
        dyc = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = bmm_bwd_dx(dyc, w, out_dtype=x.dtype, tile=dx_tile,
                            splits=dx_splits)
        if ctx.needs_input_grad[1]:
            dw = bmm_bwd_dw(x, dyc, out_dtype=w.dtype, tile=dw_tile,
                            splits=dw_splits)
        return dx, dw, None, None, None, None
