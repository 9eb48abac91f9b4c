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
the JAX package: `attention_decode` raises under grad, and so does
`attention_partial`, one key span's (o, lse) through the lse forward at a
relative extent, the sequence split's building block.  So is `ssd`,
the SSD chunk scan (its TPU kernel has no VJP).

A wrapper called without a plan resolves it through the registry's
autotune cache (`core/backends.py::tile_plan`) under the key the engine's
dispatch uses, as the JAX wrappers' `_cached_blocks` do: `matmul` under
``("matmul", (M, K, N))``, `bmm` under ``("bmm", (B, M, K, N))``, the
backward kernels' plans, only under grad, under ``("gemm_bwd", (variant,
...))`` (variants ``dx``, ``dw``, ``bdx``, ``bdw``), `attention` and
`FlashAttention`'s backward under ``("attention", (q_shape, k_shape))``
and ``("attention_bwd", ...)``, and the decode's split count under
``("attention_decode", ...)``.  Under the default policy each key
resolves to its rule (`default_tiles`, `bmm_plan_for`,
`gemm.bwd_plan_for`, `flash_attention.plan_for` / `bwd_plan_for`,
`decode_splits`); under ``measure`` the candidates below are timed on the
card and the fastest persisted.  Only plans are candidates, and every plan
gives the same bits.  The backward's split count (`default_bwd_tiles`) and
the decode's (`decode_splits`) set the bits, so they stay the shape's
under every policy: a ``gemm_bwd`` key picks the plan alone, and the
``attention_decode`` key has no candidates and is never timed.
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
    an output element's summation order (no split-K), only the speed.
    The heuristic pick of the ``matmul`` and ``conv2d`` keys, the
    counterpart of the JAX ``pick_blocks`` / ``default_blocks``."""
    return gemm_kernel.plan_for(m, k, n)


def bmm_plan_for(m: int, k: int, n: int) -> gemm_kernel.Plan:
    """The batched forward's plan for (B, M, K) @ (B, K, N), from one
    matrix's shape (the batch stays out, as out of the dispatch key).

    For a contraction of 2048 or more, as measured fastest at
    llama4-scout's expert GEMMs (16 experts, 5120 <-> 8192, 8 to 160 rows;
    ``kernels/time_gemm.py --bmm``, ``PERF.md``): 8-row blocks up to 8
    rows; above, regime B's tiles at any row count (the batch fills the
    card, and regime A's 64-row blocks compute every row of the tile one
    output column a thread): 128 x 128 where its row blocks cover no more
    rows than 64 x 32's, else 64 x 32.  A shorter contraction takes
    `default_tiles`.  For speed only: every plan gives the same bits.
    The heuristic pick of the ``bmm`` key, the counterpart of the JAX
    ``default_blocks("bmm", ...)``."""
    if k < 2048:
        return default_tiles(m, k, n)
    if m <= 8:
        return gemm_kernel.PLANS[0]
    if -(-m // 128) * 128 <= -(-m // 64) * 64:
        return gemm_kernel.PLANS[3]
    return gemm_kernel.PLANS[4]


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
    the forward's plan (a `gemm.Plan` or its tuple), else the registry
    resolves the ``matmul`` key (`default_tiles` under the default
    policy).  w is row-major, or the
    transpose of a row-major tensor (read in place, forward and backward).
    Differentiable: with grad enabled and an operand that requires it, the
    call goes through `gemm.GemmFused`, whose backward takes the plans of
    the ``gemm_bwd`` keys ``dx`` and ``dw`` and `default_bwd_tiles`' split
    counts (for a transposed w, dW is the (N, K) product dY^T . X, keyed
    and planned as such).  On a CPU tensor the kernel wrappers run
    their plain versions.
    """
    m, k = x.shape
    n = w.shape[1]
    plan = tiles or cached_plan("matmul", (m, k, n), x.dtype)
    if not (w.is_contiguous() or gemm_kernel.is_transposed(w)):
        raise ValueError(f"w {tuple(w.shape)} must be contiguous or the "
                         f"transpose of a contiguous tensor: a weight is "
                         f"never copied per call")
    x = x.contiguous()
    scale = None if scale is None else scale.float().contiguous()
    shift = None if shift is None else shift.float().contiguous()
    out_dtype = out_dtype or x.dtype
    if needs_grad(x, w, scale, shift):
        dw_plan = (cached_bwd_plan("dw", n, m, k, x.dtype)
                   if not w.is_contiguous()
                   else cached_bwd_plan("dw", k, m, n, x.dtype))
        return gemm_kernel.GemmFused.apply(
            x, w, scale, shift, act, out_dtype, plan,
            cached_bwd_plan("dx", m, n, k, x.dtype), dw_plan)
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

    `tiles` pins the forward's plan, else the registry resolves the
    ``bmm`` key (B, M, K, N), which carries the batch, since the batch is
    what fills the card (`bmm_plan_for` of one matrix under the default
    policy).  Both operands are made contiguous.  Differentiable: with
    grad enabled and an operand that requires it, the call goes through
    `gemm.BmmFn`, whose backward takes the plans of the ``gemm_bwd`` keys
    ``bdx`` and ``bdw`` (with the batch) and `default_bwd_tiles`' split
    counts.  On a CPU tensor the kernel wrappers run their plain versions.
    """
    validate_bmm_shapes(x, w)
    b, m, k = x.shape
    n = w.shape[2]
    plan = tiles or cached_plan("bmm", (b, m, k, n), x.dtype)
    x, w = x.contiguous(), w.contiguous()
    out_dtype = out_dtype or x.dtype
    if needs_grad(x, w):
        return gemm_kernel.BmmFn.apply(
            x, w, out_dtype, plan,
            cached_bwd_plan("bdx", m, n, k, x.dtype, batch=b),
            cached_bwd_plan("bdw", k, m, n, x.dtype, batch=b))
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
              causal: bool = True, plan: tuple = ()) -> torch.Tensor:
    """Grouped flash attention, any sequence lengths, through the forward
    kernel: q (B, Sq, H, D), k / v (B, Skv, KV, D) with H % KV == 0, head h
    attends kv-head h // (H // KV) with no broadcast.  ``kv_len`` (None,
    an int, or a scalar or (B,) tensor) masks keys at or past it, clamped
    to Skv; causal queries right-align against kv_len (else Skv); rows with
    no live key are exact 0.  Returns (B, Sq, H, D) in q's dtype.
    `plan` pins the forward's plan, else the registry resolves the
    ``attention`` key (`flash_attention.plan_for` under the default
    policy).  Differentiable: with grad enabled and an operand that
    requires it the call goes through `flash_attention.FlashAttention` (the
    lse forward and the dQ / dK / dV kernels, dQ under the plan of the
    ``attention_bwd`` key); the fold of sm_scale into q stays an ordinary
    differentiable multiply outside it."""
    validate_attention_shapes(q, k, v)
    kvl = normalize_kv_len(kv_len, q.shape[0], k.shape[1], q.device)
    key = (tuple(q.shape), tuple(k.shape))
    # A decode-shaped key resolves to () (the split-KV kernel's); called
    # here, such a problem takes `flash_attention.plan_for`'s plan.
    plan = plan or cached_plan("attention", key, q.dtype) or None
    qs = scale_queries(q, sm_scale)
    if needs_grad(qs, k, v):
        return flash_kernel.FlashAttention.apply(
            qs, k, v, kvl, causal, plan,
            cached_plan("attention_bwd", key, q.dtype))
    return flash_kernel.flash_attention_fwd(qs, k, v, kvl, causal=causal,
                                            plan=plan)


def attention_decode(q, k, v, kv_len=None, sm_scale=None, *,
                     causal: bool = True) -> torch.Tensor:
    """`attention`'s contract computed by the split-KV decode kernel,
    which merges its partials in the same launch with `combine`'s bits
    (past `MERGE_MAX_SPLITS` splits, `combine` merges them), over the
    spans of `decode_splits`.  Keys past Skv are masked by kv_len (Skv
    when None).  Partials and the merge are fp32; returns (B, Sq, H, D) in
    q's dtype.  The split count comes through the registry's
    ``attention_decode`` key, which always resolves to `decode_splits`
    (the split sets the bits, so nothing is timed).  Inference only, as
    in the JAX package: raises NotImplementedError under grad."""
    validate_attention_shapes(q, k, v)
    if needs_grad(q, k, v, sm_scale):
        raise NotImplementedError(
            f"the split-KV decode formulation (Sq {q.shape[1]} against Skv "
            f"{k.shape[1]}) is inference only: it has no backward kernels")
    b, skv = q.shape[0], k.shape[1]
    n_splits, span = cached_plan("attention_decode",
                                 (tuple(q.shape), tuple(k.shape)), q.dtype)
    kvl = normalize_kv_len(skv if kv_len is None else kv_len, b, skv,
                           q.device)
    qs = scale_queries(q, sm_scale)
    if n_splits <= decode_kernel.MERGE_MAX_SPLITS:
        return decode_kernel.flash_decode(qs, k, v, kvl, causal=causal,
                                          n_splits=n_splits, span=span)[0]
    o_part, lse_part = decode_kernel.flash_decode_partials(
        qs, k, v, kvl, causal=causal, n_splits=n_splits, span=span)
    return decode_kernel.merge_plain(o_part, lse_part, q.dtype)


def attention_partial(q, k, v, kv_len, sm_scale=None, *,
                      causal: bool = True):
    """Partial attention over ONE key span, the sequence-split building
    block (kernels/sharded.py): returns (o, lse).

    q (B, Sq, H, D) against a local span k / v (B, Skv, KV, D); ``kv_len``
    (an int, or a scalar or (B,) tensor) is the GLOBAL live extent minus
    the span's start, so it may exceed Skv (every local key is live) or be
    <= 0 (no local key is).  Causal queries right-align against that same
    relative extent, which puts the global diagonal span-locally, so it is
    deliberately NOT clamped (the lse forward's relative contract,
    `flash_attention.flash_attention_fwd`).

    Returns ``o`` (B, H, Sq, D) span-normalised in q's dtype and ``lse``
    (B, H, Sq) fp32, with `flash_decode.EMPTY_SPAN_LSE` on the rows that
    see no live key (the kernel stores 0 there; liveness is set
    analytically, as in the JAX package): the per-span contract of
    `flash_decode.combine`.  The lse forward kernel on a CUDA tensor, its
    plain version on a CPU one.  Inference only: raises
    NotImplementedError under grad."""
    validate_attention_shapes(q, k, v)
    if needs_grad(q, k, v, sm_scale):
        raise NotImplementedError(
            "attention_partial (the sequence-split partials) is inference "
            "only: it has no backward")
    b, sq = q.shape[:2]
    if kv_len is None:
        raise ValueError("attention_partial needs the span's relative "
                         "kv_len")
    validate_kv_len(kv_len, b)
    kvl = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    kvl = kvl.reshape(-1).expand(b).contiguous()
    # A decode-shaped key resolves to () (the split-KV kernel's); here
    # such a span takes `flash_attention.plan_for`'s plan.
    plan = cached_plan("attention", (tuple(q.shape), tuple(k.shape)),
                       q.dtype) or None
    o, lse = flash_kernel.flash_attention_fwd(
        scale_queries(q, sm_scale), k, v, kvl, causal=causal,
        return_lse=True, plan=plan, relative=True)
    # a row sees a live key iff kv_len > 0 and, causal, its extent
    # kv_len - Sq + i + 1 reaches key 0
    live = (kvl[:, None] > 0).expand(-1, sq)
    if causal:
        rows = torch.arange(sq, device=q.device)[None, :]
        live = live & (rows >= sq - kvl[:, None])
    lse = torch.where(live[:, None, :], lse, decode_kernel.EMPTY_SPAN_LSE)
    return o.transpose(1, 2), lse


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
    kernel wrapper).  Inference only: the kernel has no backward, so the
    `cuda` backend calls it only without grad and takes the einsum form
    (`core/backends.py::_cuda_ssd`) under grad."""
    dtf = dt.float().contiguous()
    da = (dtf * A.float()).contiguous()
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    init = None if init_state is None else init_state.float().contiguous()
    return ssd_kernel.ssd_scan(x, dtf, da, B, C, chunk=chunk,
                               init_state=init)


# -------------------------------------------------------- autotune surface ---
# The measured autotuner's hooks for the `cuda` backend (the counterpart of
# the JAX `pallas` hooks, ``repro/kernels/ops.py``): per key, the candidate
# plans with the heuristic pick first, a bench thunk that runs one launch
# under a candidate on zero operands of the key's shape on the current CUDA
# device, and the legality check a persisted or measured pick must pass
# before it is launched.  A candidate is a plan, never a split count: every
# plan gives the same bits.

GEMM_BWD_VARIANTS = ("dx", "dw", "bdx", "bdw")


def attention_dims(shapes: tuple) -> tuple[int, int, int, int, int, int]:
    """Normalize the attention key shapes ``(q_shape, k_shape)``, q (B,
    Sq, H, D) and k (B, Skv, KV, D), to (b, sq, skv, h, kv, d)."""
    (b, sq, h, d), (_, skv, kv, _) = shapes
    return b, sq, skv, h, kv, d


def gemm_bwd_key(variant: str, rows: int, kdim: int, cols: int,
                 batch: int = 1) -> tuple:
    """The ``gemm_bwd`` key shapes of a backward GEMM over its own (rows,
    contraction, cols), as `default_bwd_tiles` takes them: ``(variant,
    rows, kdim, cols)`` for ``dx`` / ``dw`` (the JAX key) and ``(variant,
    batch, rows, kdim, cols)`` for the batched ``bdx`` / ``bdw``, whose
    batch fills the card."""
    if variant not in GEMM_BWD_VARIANTS:
        raise ValueError(f"unknown gemm_bwd variant {variant!r}; expected "
                         f"one of {GEMM_BWD_VARIANTS}")
    if variant.startswith("b"):
        return (variant, batch, rows, kdim, cols)
    return (variant, rows, kdim, cols)


def gemm_bwd_dims(shapes: tuple) -> tuple[str, int, int, int, int]:
    """(base variant "dx" / "dw", rows, kdim, cols, batch) of a
    ``gemm_bwd`` key's shapes (`gemm_bwd_key`)."""
    variant, *dims = shapes
    if variant not in GEMM_BWD_VARIANTS:
        raise ValueError(f"unknown gemm_bwd variant {variant!r}; expected "
                         f"one of {GEMM_BWD_VARIANTS}")
    if variant.startswith("b"):
        batch, rows, kdim, cols = dims
    else:
        (rows, kdim, cols), batch = dims, 1
    return variant.removeprefix("b"), rows, kdim, cols, batch


def cached_plan(op: str, shapes: tuple, dtype) -> tuple:
    """The `cuda` backend's plan for one launch, resolved through the
    registry's autotune cache under the key engine dispatch uses (the
    JAX `_cached_blocks`), so both paths agree and the measure policy
    covers direct wrapper calls too.  Imported lazily: core/backends.py
    imports this module at load time."""
    from repro_torch.core import backends
    return backends.get_backend("cuda").tiles(op, shapes, dtype)


def cached_bwd_plan(variant: str, rows: int, kdim: int, cols: int, dtype,
                    batch: int = 1) -> tuple[tuple, int]:
    """(plan, splits) of a backward GEMM, as `bwd_plan`, with the plan
    resolved through the registry under its ``gemm_bwd`` key and the
    split count from `default_bwd_tiles` under every policy (it sets the
    bits)."""
    base = variant.removeprefix("b")
    return (cached_plan("gemm_bwd",
                        gemm_bwd_key(variant, rows, kdim, cols, batch),
                        dtype),
            default_bwd_tiles(base, rows, kdim, cols, batch)[3])


def _with_first(base: tuple, plans) -> list[tuple]:
    return [base] + [p for p in plans if p != base]


def candidate_blocks(op: str, m: int, k: int, n: int, dtype,
                     batch: int = 1) -> list:
    """Candidate forward plans of a ``matmul``, ``conv2d`` (its im2col
    GEMM) or ``bmm`` key: every plan of `gemm.PLANS`, the heuristic pick
    first (`default_tiles`, `bmm_plan_for` for bmm).  Every plan runs any
    shape (the kernels mask the ragged edges) and gives the same bits."""
    base = bmm_plan_for(m, k, n) if op == "bmm" else default_tiles(m, k, n)
    return _with_first(base, gemm_kernel.PLANS)


def candidate_gemm_bwd_blocks(variant: str, rows: int, kdim: int, cols: int,
                              dtype, batch: int = 1) -> list:
    """Candidate plans of a ``gemm_bwd`` key: every plan of
    `gemm.BWD_PLANS`, `gemm.bwd_plan_for`'s first.  The split count is
    not a candidate: it stays `default_bwd_tiles`'."""
    base = gemm_kernel.bwd_plan_for(variant.removeprefix("b"), rows, kdim,
                                    cols, batch)
    return _with_first(base, gemm_kernel.BWD_PLANS)


def candidate_attention_blocks(b: int, sq: int, skv: int, h: int, kv: int,
                               d: int, dtype) -> list:
    """Candidate forward plans of an ``attention`` key: the plans
    instantiated at head dim d (`flash_attention.plans_at`),
    `flash_attention.plan_for`'s first; none for a decode-shaped dispatch
    (the split-KV kernel runs it) or a head dim the kernel lacks."""
    if (use_decode_formulation(sq, skv)
            or d not in flash_kernel.FWD_HEAD_DIMS):
        return []
    return _with_first(flash_kernel.plan_for(b, sq, h, kv, d),
                       flash_kernel.plans_at(d))


def candidate_attention_bwd_blocks(b: int, sq: int, skv: int, h: int,
                                   kv: int, d: int, dtype) -> list:
    """Candidate dQ plans of an ``attention_bwd`` key: those instantiated
    at head dim d (`flash_attention.bwd_plans_at`),
    `flash_attention.bwd_plan_for`'s first; none at a head dim the
    backward kernels lack.  The dK / dV kernel has one launch shape."""
    if d not in flash_kernel.BWD_HEAD_DIMS:
        return []
    return _with_first(flash_kernel.bwd_plan_for(b, sq, h, kv, d),
                       flash_kernel.bwd_plans_at(d))


def _bench_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def bench_thunk(op: str, m: int, k: int, n: int, dtype, tiles: tuple,
                batch: int = 1):
    """Zero-arg thunk running one forward GEMM launch under plan `tiles`
    on zero operands (a GEMM does the same work whatever the values) on
    the current CUDA device, or None without a card.  ``conv2d`` is timed
    as its im2col GEMM, ``bmm`` at its own batch."""
    if not torch.cuda.is_available():
        return None
    dt, dev = _bench_dtype(dtype), torch.device("cuda")
    if op == "bmm":
        x = torch.zeros((batch, m, k), dtype=dt, device=dev)
        w = torch.zeros((batch, k, n), dtype=dt, device=dev)
        return lambda: gemm_kernel.bmm_fwd(x, w, plan=tiles)
    x = torch.zeros((m, k), dtype=dt, device=dev)
    w = torch.zeros((k, n), dtype=dt, device=dev)
    return lambda: gemm_kernel.gemm_fused_fwd(x, w, plan=tiles)


def gemm_bwd_bench_thunk(variant: str, rows: int, kdim: int, cols: int,
                         dtype, tiles: tuple, batch: int = 1):
    """Zero-arg thunk running one backward kernel under plan `tiles` at
    the split `default_bwd_tiles` gives the shape, on zero operands on the
    current CUDA device, or None without a card:

      dx : dY (rows, kdim) . W^T, W (cols, kdim)
      dw : X^T . dY, X (kdim, rows), dY (kdim, cols)
      bdx / bdw: the batched forms at their batch."""
    if not torch.cuda.is_available():
        return None
    base = variant.removeprefix("b")
    splits = default_bwd_tiles(base, rows, kdim, cols, batch)[3]
    dt, dev = _bench_dtype(dtype), torch.device("cuda")
    lead = (batch,) if variant.startswith("b") else ()
    if base == "dx":
        a = torch.zeros((*lead, rows, kdim), dtype=dt, device=dev)
        b = torch.zeros((*lead, cols, kdim), dtype=dt, device=dev)
        fn = gemm_kernel.bmm_bwd_dx if lead else gemm_kernel.gemm_bwd_dx
    else:
        a = torch.zeros((*lead, kdim, rows), dtype=dt, device=dev)
        b = torch.zeros((*lead, kdim, cols), dtype=dt, device=dev)
        fn = gemm_kernel.bmm_bwd_dw if lead else gemm_kernel.gemm_bwd_dw
    return lambda: fn(a, b, plan=tiles, splits=splits)


def _zero_qkv(b, sq, skv, h, kv, d, dtype):
    dt, dev = _bench_dtype(dtype), torch.device("cuda")
    return (torch.zeros((b, sq, h, d), dtype=dt, device=dev),
            torch.zeros((b, skv, kv, d), dtype=dt, device=dev),
            torch.zeros((b, skv, kv, d), dtype=dt, device=dev))


def attention_bench_thunk(b: int, sq: int, skv: int, h: int, kv: int,
                          d: int, dtype, tiles: tuple):
    """Zero-arg thunk running one flash forward launch under plan `tiles`
    on zero operands on the current CUDA device, causal where Sq <= Skv
    (as the JAX bench: masking and the softmax do the same work whatever
    the values), or None without a card."""
    if not torch.cuda.is_available():
        return None
    q, k, v = _zero_qkv(b, sq, skv, h, kv, d, dtype)
    return lambda: flash_kernel.flash_attention_fwd(
        q, k, v, causal=sq <= skv, plan=tiles)


def attention_bwd_bench_thunk(b: int, sq: int, skv: int, h: int, kv: int,
                              d: int, dtype, tiles: tuple):
    """Zero-arg thunk running one dQ launch under plan `tiles` on zero
    operands (dO, lse and Delta included) on the current CUDA device, or
    None without a card.  Only dQ has plans; timing the kernel directly
    keeps the timed launch out of the autotune cache."""
    if not torch.cuda.is_available():
        return None
    q, k, v = _zero_qkv(b, sq, skv, h, kv, d, dtype)
    rows = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    do = torch.zeros_like(q)
    return lambda: flash_kernel.flash_attention_bwd_dq(
        q, k, v, do, rows, rows, causal=sq <= skv, plan=tiles)


def _malformed(tiles, fields: str) -> list[str]:
    return [f"plan {tiles!r} is not a well-formed {fields}"]


def validate_gemm_tiles(m: int, k: int, n: int, dtype, tiles: tuple, *,
                        bwd: bool = False) -> list[str]:
    """Legality of a GEMM plan for an (m, k, n) problem: it must be an
    instantiated plan, one of `gemm.PLANS` (forward) or `gemm.BWD_PLANS`
    (``bwd``), which a launcher would otherwise refuse.  Every
    instantiated plan runs every shape.  Returns problem strings; empty
    means legal (the JAX `validate_gemm_tiles`' contract)."""
    plans = gemm_kernel.BWD_PLANS if bwd else gemm_kernel.PLANS
    try:
        plan = (gemm_kernel.BwdPlan if bwd else gemm_kernel.Plan)(*tiles)
    except TypeError:
        return _malformed(tiles, "(bm, bn)" if bwd else "(regime, bm, bn)")
    if plan not in plans:
        which = "backward" if bwd else "forward"
        return [f"{plan} is not an instantiated {which} GEMM plan; the "
                f"kernels have {plans}"]
    return []


def validate_attention_tiles(sq: int, skv: int, d: int, dtype,
                             tiles: tuple, *, bwd: bool = False
                             ) -> list[str]:
    """Legality of a flash-attention plan at head dim d: the forward's
    must be one of `flash_attention.plans_at(d)` (its lanes split the head
    dim and its fp32 block, `fwd_smem_bytes`, fits in `MAX_SMEM`), the dQ
    kernel's (``bwd``) one of `bwd_plans_at(d)` (`bwd_smem_bytes`).
    Returns problem strings; empty means legal."""
    fk = flash_kernel
    try:
        plan = (fk.BwdPlan if bwd else fk.FwdPlan)(*tiles)
    except TypeError:
        return _malformed(tiles, "(rows,)" if bwd
                          else "(rows, threads, lanes)")
    if bwd:
        admitted, smem = fk.bwd_plans_at(d), fk.bwd_smem_bytes
        plans = fk.BWD_PLANS
    else:
        admitted, smem = fk.plans_at(d), fk.fwd_smem_bytes
        plans = fk.PLANS
    if plan not in plans:
        return [f"{plan} is not an instantiated plan; the kernel has "
                f"{plans}"]
    if plan not in admitted:
        return [f"{plan} does not fit at head dim {d}: its fp32 block "
                f"needs {smem(d, plan)} bytes of shared memory (at most "
                f"{fk.MAX_SMEM}) or its lanes do not split the head dim; "
                f"admitted: {admitted}"]
    return []


def validate_attention_decode_tiles(skv: int, kv: int, tiles: tuple
                                    ) -> list[str]:
    """The decode's (n_splits, span) is not a plan: its split sets the
    bits, so the only legal value is `decode_splits`' for the shape."""
    want = decode_splits(skv, kv)
    if tuple(tiles) != want:
        return [f"decode split {tuple(tiles)} is not decode_splits' {want} "
                f"for Skv {skv} over {kv} kv-heads: the split sets the bits"]
    return []
