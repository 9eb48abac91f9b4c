"""Any-shape wrappers over the port's kernels (PyTorch port of
``repro/kernels/ops.py``: `matmul`, `bmm`, `attention`,
`attention_decode`, `ssd` and their shape checks).

The JAX wrappers pad to tile multiples and slice the result, because the
TPU kernels' BlockSpecs need whole blocks.  The port's CUDA kernels mask
the ragged edges themselves, so these wrappers do NOT pad.  `matmul` makes
x contiguous and picks the tile.  A weight is never copied per call: w must
be row-major, or the transpose of a row-major tensor (a tied LM head's
``embed.t()``), which the kernels read in place, forward and backward.
Any (M, K, N) runs, the property of the paper's Figure 3.  The attention
wrappers fold sm_scale into q in fp32 and hand the kernels q, k and v in
the engine layout (B, S, heads, D) through strides, with no transpose.

With grad enabled and an operand that requires it, `matmul` goes through
`gemm.GemmFused`, `bmm` through `gemm.BmmFn` and `attention` through
`flash_attention.FlashAttention`:
the forward kernels also write their training residuals (act'(u) and the
accumulator; the softmax lse) and the backward runs the dX / dW and the
dQ / dK / dV kernels.  Otherwise each makes the forward-only launch that
serving makes.  The split-KV decode formulation is inference only, as in
the JAX package: `attention_decode` raises under grad.  So is `ssd`,
the SSD chunk scan (its TPU kernel has no VJP).

The forward's plan (regime and tile), the backward's plan and its split
count are fixed heuristics from the shape alone (`default_tiles`,
`bwd_plan`: `gemm.bwd_plan_for` and `default_bwd_tiles`).  A measured
autotuner, the counterpart of ``repro/core/autotune.py``, is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import flash_decode as decode_kernel
from repro_torch.kernels import gemm as gemm_kernel
from repro_torch.kernels import ssd as ssd_kernel

# The backward's split rule (pinned: the split sets the bits) counts the
# threads of square output tiles, 64 x 64 from this many on, else 32 x 32;
# the kernels' own tiles are gemm.bwd_plan_for's.
_MIN_BLOCKS_64 = 264
# A backward GEMM whose output tiles give fewer threads than half of what
# the card holds resident (132 SMs x 2048) splits its contraction until
# they do, each piece at least _MIN_SPLIT_DEPTH long.
_SPLIT_THREADS = 132 * 1024
_MIN_SPLIT_DEPTH = 512
BWD_VARIANTS = ("dx", "dw")


def default_tiles(m: int, k: int, n: int) -> gemm_kernel.Plan:
    """The forward's plan for an (M, K, N) GEMM (`gemm.plan_for`): regime
    A up to 64 rows, B above, each with its tile.  The plan never changes
    an output element's summation order (no split-K), only the speed."""
    return gemm_kernel.plan_for(m, k, n)


def _bwd_tile(rows: int, cols: int) -> int:
    """The split rule's square output tile for a (rows, cols) output: 64
    when there are enough 64 x 64 tiles to fill the card, else 32."""
    blocks = -(-rows // 64) * -(-cols // 64)
    return 64 if blocks >= _MIN_BLOCKS_64 and cols > 32 else 32


def default_bwd_tiles(variant: str, rows: int, kdim: int, cols: int,
                      batch: int = 1) -> tuple[int, int, int, int]:
    """(bm, bk, bn, splits) for a backward GEMM over its own (rows,
    contraction, cols): ("dx", M, N, K) or ("dw", K, M, N), `batch` of
    them for the bmm op.  The tile is `_bwd_tile`'s for one matrix and
    bk is `gemm.BK`: they are what the split is counted with, pinned as
    the 16-deep square-tile kernels had them; the kernels' plan is
    `gemm.bwd_plan_for`'s and never feeds the split (`bwd_plan`).
    When the output tiles' threads, counted over the whole batch, would
    fill less than half the card, the contraction is split into enough
    pieces to reach `_SPLIT_THREADS`, none shorter than `_MIN_SPLIT_DEPTH`,
    and no more than the grid's z extent takes (batch x splits <= 65,535).
    The split depends on the shape alone, so a result has the same bits
    run to run, and every output is one fmaf chain per piece, the pieces
    added in order (the counterpart of ``default_gemm_bwd_blocks``)."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown backward variant {variant!r}; expected "
                         f"one of {BWD_VARIANTS}")
    t, bk = _bwd_tile(rows, cols), gemm_kernel.BK
    threads = batch * -(-rows // t) * -(-cols // t) * (t // 4) ** 2
    splits = max(1, min(-(-_SPLIT_THREADS // max(1, threads)),
                        kdim // _MIN_SPLIT_DEPTH,
                        gemm_kernel.MAX_GRID_Z // max(1, batch)))
    return (t, bk, t, gemm_kernel.split_chunk(kdim, splits)[1])


def bwd_plan(variant: str, rows: int, kdim: int, cols: int,
             batch: int = 1) -> tuple[gemm_kernel.BwdPlan, int]:
    """(plan, splits) that a backward GEMM over (rows, contraction, cols)
    is launched with, as `default_bwd_tiles` takes them: the kernels' plan
    from `gemm.bwd_plan_for` (speed only) and the split count from
    `default_bwd_tiles` (which sets the bits)."""
    return (gemm_kernel.bwd_plan_for(variant, rows, kdim, cols, batch),
            default_bwd_tiles(variant, rows, kdim, cols, batch)[3])


def needs_grad(*operands) -> bool:
    """Whether autograd will differentiate a call on `operands`: grad is
    enabled and a tensor among them requires it (None and non-tensors are
    ignored)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in operands)


def matmul(x, w, scale=None, shift=None, *, act: str = "linear",
           out_dtype=None, tiles: tuple = ()) -> torch.Tensor:
    """Fused GEMM act((x @ w) * scale + shift) on the compute engine, any
    (M, K) x (K, N).

    scale/shift are (N,) vectors (cast to float32) or None; `tiles` pins
    the forward's plan (a `gemm.Plan` or its tuple), else `default_tiles`
    picks.  w is row-major, or the
    transpose of a row-major tensor (read in place, forward and backward).
    Differentiable: with grad enabled and an operand that requires it, the
    call goes through `gemm.GemmFused`, whose backward uses `bwd_plan`
    (for a transposed w, dW is the (N, K) product dY^T . X, planned as
    such).  On a CPU tensor the kernel wrappers run
    their plain versions.
    """
    m, k = x.shape
    n = w.shape[1]
    plan = tiles or default_tiles(m, k, n)
    if not (w.is_contiguous() or gemm_kernel.is_transposed(w)):
        raise ValueError(f"w {tuple(w.shape)} must be contiguous or the "
                         f"transpose of a contiguous tensor: a weight is "
                         f"never copied per call")
    x = x.contiguous()
    scale = None if scale is None else scale.float().contiguous()
    shift = None if shift is None else shift.float().contiguous()
    out_dtype = out_dtype or x.dtype
    if needs_grad(x, w, scale, shift):
        dw_plan = (bwd_plan("dw", n, m, k) if not w.is_contiguous()
                   else bwd_plan("dw", k, m, n))
        return gemm_kernel.GemmFused.apply(
            x, w, scale, shift, act, out_dtype, plan,
            bwd_plan("dx", m, n, k), dw_plan)
    return gemm_kernel.gemm_fused_fwd(x, w, scale, shift, act=act,
                                      out_dtype=out_dtype, plan=plan)


def validate_bmm_shapes(x, w) -> None:
    """The bmm contract: x (B, M, K) and w (B, K, N).  Raises ValueError
    naming the shapes, at dispatch and not inside a kernel."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or (
            x.shape[2] != w.shape[1]):
        raise ValueError(f"bmm needs x (B, M, K) and w (B, K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def bmm(x, w, *, out_dtype=None, tiles: tuple = ()) -> torch.Tensor:
    """Batched GEMM (B, M, K) @ (B, K, N) -> (B, M, N) on the engine, fp32
    accumulation, the result in `out_dtype` (default x's dtype); any M, K
    and N (the kernels mask the ragged edges where the JAX wrapper pads).

    `tiles` pins the forward's plan, else `default_tiles` of one matrix picks
    (the batch stays out of the pick, as out of the JAX key).  Both
    operands are made contiguous.  Differentiable: with grad enabled and
    an operand that requires it, the call goes through `gemm.BmmFn`, whose
    backward plans count the batch (`bwd_plan`).  On a CPU
    tensor the kernel wrappers run their plain versions.
    """
    validate_bmm_shapes(x, w)
    b, m, k = x.shape
    n = w.shape[2]
    plan = tiles or default_tiles(m, k, n)
    x, w = x.contiguous(), w.contiguous()
    out_dtype = out_dtype or x.dtype
    if needs_grad(x, w):
        return gemm_kernel.BmmFn.apply(x, w, out_dtype, plan,
                                       bwd_plan("dx", m, n, k, b),
                                       bwd_plan("dw", k, m, n, b))
    return gemm_kernel.bmm_fwd(x, w, out_dtype=out_dtype, plan=plan)


# ------------------------------------------------------------- attention ---
# Decode-shaped dispatches (a short query against a deep key extent) take
# the split-KV formulation: same constants as the JAX package, so the same
# dispatches pick the same formulation.
DECODE_MAX_SQ = 8
DECODE_MIN_SKV = 256
# The decode grid is (splits, B * KV, row chunks); splitting aims at this
# many blocks at batch 1 (one per SM of the H100), one 64-key tile at least
# per split.
_DECODE_BLOCKS = 132


def use_decode_formulation(sq: int, skv: int) -> bool:
    """Whether an (Sq, Skv) attention dispatch is decode-shaped: Sq within
    DECODE_MAX_SQ and the key extent at or above DECODE_MIN_SKV."""
    return sq <= DECODE_MAX_SQ and skv >= DECODE_MIN_SKV


def decode_splits(skv: int, kv_heads: int) -> tuple[int, int]:
    """(n_splits, span) of the split-KV decode for a key extent of `skv`
    over `kv_heads` kv-heads: enough spans that the grid has about
    `_DECODE_BLOCKS` blocks at batch 1, each span a whole number of 64-key
    tiles, no span empty.  From the shape alone and not from the batch, so
    a sequence's bits are the same run to run and in every batch bucket."""
    tile = decode_kernel.TILE
    tiles = max(1, -(-skv // tile))
    want = max(1, min(tiles, -(-_DECODE_BLOCKS // kv_heads)))
    span = tile * -(-tiles // want)
    return -(-(tiles * tile) // span), span


def validate_attention_shapes(q, k, v) -> None:
    """Grouped-layout contract: q (B, Sq, H, D), k / v (B, Skv, KV, D) with
    KV <= H, H % KV == 0, one dtype.  Raises ValueError naming the
    offending shapes or dtypes, at dispatch and not inside a kernel."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention expects 4-D (B, S, heads, head_dim) "
                         f"operands; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    kb, _, kvh, kd = k.shape
    if kb != b or kd != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim")
    if kvh == 0 or kvh > h or h % kvh != 0:
        raise ValueError(
            f"grouped attention requires KV heads to evenly divide query "
            f"heads (KV <= H, H % KV == 0); got H={h}, KV={kvh}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtype mismatch: q={q.dtype}, k={k.dtype}, "
                         f"v={v.dtype}")


def validate_kv_len(kv_len, b: int) -> None:
    """A kv_len is None, an int, a scalar tensor or a (B,) tensor; raises
    ValueError on any other shape."""
    if kv_len is None or isinstance(kv_len, int):
        return
    shape = tuple(torch.as_tensor(kv_len).shape)
    if len(shape) > 1 or (len(shape) == 1 and shape[0] != b):
        raise ValueError(f"kv_len must be a scalar or ({b},) vector; got "
                         f"shape {shape}")


def normalize_kv_len(kv_len, b: int, skv: int, device) -> torch.Tensor | None:
    """A kv_len argument as a contiguous (B,) int32 tensor on `device`,
    clamped to Skv, or None (see `validate_kv_len` for the forms)."""
    if kv_len is None:
        return None
    validate_kv_len(kv_len, b)
    kvl = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return torch.clamp(kvl.reshape(-1).expand(b), max=skv).contiguous()


def scale_queries(q, sm_scale=None) -> torch.Tensor:
    """q * sm_scale in fp32, cast back to q's dtype (the JAX wrappers' fold
    of a possibly traced scale into q); sm_scale defaults to 1/sqrt(D)."""
    scale = 1.0 / q.shape[-1] ** 0.5 if sm_scale is None else sm_scale
    if isinstance(scale, torch.Tensor):
        scale = scale.to(device=q.device, dtype=torch.float32)
    return (q.float() * scale).to(q.dtype)


def attention(q, k, v, kv_len=None, sm_scale=None, *,
              causal: bool = True) -> torch.Tensor:
    """Grouped flash attention, any sequence lengths, through the forward
    kernel: q (B, Sq, H, D), k / v (B, Skv, KV, D) with H % KV == 0, head h
    attends kv-head h // (H // KV) with no broadcast.  ``kv_len`` (None,
    an int, or a scalar or (B,) tensor) masks keys at or past it, clamped
    to Skv; causal queries right-align against kv_len (else Skv); rows with
    no live key are exact 0.  Returns (B, Sq, H, D) in q's dtype.
    Differentiable: with grad enabled and an operand that requires it the
    call goes through `flash_attention.FlashAttention` (the lse forward and
    the dQ / dK / dV kernels); the fold of sm_scale into q stays an
    ordinary differentiable multiply outside it."""
    validate_attention_shapes(q, k, v)
    kvl = normalize_kv_len(kv_len, q.shape[0], k.shape[1], q.device)
    qs = scale_queries(q, sm_scale)
    if needs_grad(qs, k, v):
        return flash_kernel.FlashAttention.apply(qs, k, v, kvl, causal)
    return flash_kernel.flash_attention_fwd(qs, k, v, kvl, causal=causal)


def attention_decode(q, k, v, kv_len=None, sm_scale=None, *,
                     causal: bool = True) -> torch.Tensor:
    """`attention`'s contract computed by the split-KV decode kernel,
    which merges its partials in the same launch with `combine`'s bits
    (past `MERGE_MAX_SPLITS` splits, `combine` merges them), over the
    spans of `decode_splits`.  Keys past Skv are masked by kv_len (Skv
    when None).  Partials and the merge are fp32; returns (B, Sq, H, D) in
    q's dtype.  Inference only, as in the
    JAX package: raises NotImplementedError under grad."""
    validate_attention_shapes(q, k, v)
    if needs_grad(q, k, v, sm_scale):
        raise NotImplementedError(
            f"the split-KV decode formulation (Sq {q.shape[1]} against Skv "
            f"{k.shape[1]}) is inference only: it has no backward kernels")
    b = q.shape[0]
    skv, kvh = k.shape[1], k.shape[2]
    n_splits, span = decode_splits(skv, kvh)
    kvl = normalize_kv_len(skv if kv_len is None else kv_len, b, skv,
                           q.device)
    qs = scale_queries(q, sm_scale)
    if n_splits <= decode_kernel.MERGE_MAX_SPLITS:
        return decode_kernel.flash_decode(qs, k, v, kvl, causal=causal,
                                          n_splits=n_splits, span=span)[0]
    o_part, lse_part = decode_kernel.flash_decode_partials(
        qs, k, v, kvl, causal=causal, n_splits=n_splits, span=span)
    return decode_kernel.merge_plain(o_part, lse_part, q.dtype)


# ------------------------------------------------------------------- SSD ---

def ssd(x, dt, A, B, C, *, chunk: int, init_state=None):
    """The SSD chunk scan through the kernel, in the model's layout: x
    (Bt, S, H, P), dt (Bt, S, H) after softplus, A (H,) negative, B and C
    (Bt, S, G, N) read by group (head h reads group h // (H / G), never
    broadcast to the heads), any S (the kernel masks the ragged last
    chunk), an optional fp32 init_state (Bt, H, P, N).  dA = dt·A per head
    and dt are formed here in fp32.  Returns (y (Bt, S, H, P) in x's dtype,
    final state (Bt, H, P, N) fp32).  The operands are checked by
    `ssd.check_operands` (at dispatch, by the engine, and again by the
    kernel wrapper).  Inference only: the kernel has no backward, and the
    `cuda` backend's `inference_only` hook refuses every ssd dispatch
    under grad."""
    dtf = dt.float().contiguous()
    da = (dtf * A.float()).contiguous()
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    init = None if init_state is None else init_state.float().contiguous()
    return ssd_kernel.ssd_scan(x, dtf, da, B, C, chunk=chunk,
                               init_state=init)
