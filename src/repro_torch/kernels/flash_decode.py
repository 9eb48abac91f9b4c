"""Split-KV flash-decoding on Hopper.

Replaces ``repro/kernels/flash_decode.py``'s ``_decode_kernel`` (launched by
``flash_decode``) and the plain merge that follows it there on the LM
serving path: decode-shaped attention (Sq <= 8 against 256 or more key
rows, `ops.use_decode_formulation`).  The key extent is cut into
``n_splits`` spans of ``span`` keys; the kernel (``csrc/flash_decode.cu``,
hand-written CUDA C++, built by ``build.py`` and called through ctypes)
reduces each span to a partial (o, lse) and, in the same launch, merges
the partials as `combine` does, bit for bit on the card.  The source's
header says what bounds it on the H100 and what its design does about
that.

  flash_decode            the kernel wrapper: the merged output and the
                          partials, one launch
  flash_decode_partials   the kernel without the merge: (o_part, lse_part)
  flash_decode_plain      the partials in plain PyTorch
  combine                 the log-sum-exp merge of the partials, plain
                          PyTorch (as in JAX)
  merge_plain             `combine` in the output's layout and dtype

An empty span reports the sentinel lse `EMPTY_SPAN_LSE` (-1e30) and a zero
partial, which `combine` weighs to exactly 0; a row whose spans are all
empty merges to exact 0, never NaN.  Partials, lse and the merge are fp32
for every operand dtype.  The kernel is instantiated at head dims
`HEAD_DIMS` (zamba2's shared block at 112 and MLA's absorbed decode at 576,
the latent c_kv 512 + k_rope 64, among them); another head dim is refused
by name, on the CPU as on the card.  `smem_bytes` is a block's shared
memory (at 576 K and V stream through two 32-key half tiles).  The
wrappers run the plain versions only for a CPU tensor; on a CUDA tensor
they launch the kernel or raise.  `launches` counts the kernel's
launches, with or without the merge, and moves nowhere else.  Inference
only: decode is never differentiated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES, STRIDES,
                                                 check_head_dim,
                                                 check_operands, cuda_args)
from repro_torch.kernels.ref import attention_mask

HEAD_DIMS = (32, 64, 112, 128, 576)  # the decode kernel's head dims
# The lse an empty (fully-masked) key span reports; `combine` weighs such
# partials to zero.
EMPTY_SPAN_LSE = -1e30
TILE = 64  # keys per tile of the kernel; a span is a whole number of tiles
ROWS = 16  # query rows of a block of the kernel
# The most splits the kernel's merge takes: up to here its sums take
# PyTorch's order on the card (held bitwise against `combine` up to 48
# splits on an H100); at 64 and more PyTorch's `sum` takes another, so
# `ops.attention_decode` merges those with `combine`.
MERGE_MAX_SPLITS = 48
MAX_SMEM = 232448  # bytes of shared memory one block may use

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [STRIDES]
             + [ctypes.c_int] * 4)
# per device, the merge's zeroed counters; a larger buffer replaces a
# smaller one, which is kept, as a captured CUDA graph may still use it.
# Launches share them, so they run one after another (one stream).
_COUNTERS: dict = {}


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def _counters(device, n: int) -> torch.Tensor:
    """At least `n` zeroed int32 counters on `device`, which every launch
    of the kernel leaves zeroed."""
    held = _COUNTERS.setdefault(device, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return held[-1]


def smem_bytes(d: int, dtype=torch.float32) -> int:
    """Shared memory a 16-row block of the kernel at head dim `d` opts
    into (``DecSmem`` in csrc/flash_decode.cu): the q rows in fp32, two
    stages of a K and a V tile in `dtype` (rows padded by 16 bytes), or
    two 32-key half tiles where one fp32 stage of a K and a V tile would
    not fit in `MAX_SMEM` (head dim 576), and the rows' probabilities."""
    size = torch.tensor([], dtype=dtype).element_size()
    q_rows = ROWS * (d + 4) * 4
    halves = q_rows + 2 * TILE * (d + 4) * 4 + ROWS * TILE * 4 > MAX_SMEM
    tiles = 1 if halves else 4
    return q_rows + tiles * TILE * (d + 16 // size) * size + ROWS * TILE * 4


def _check_split(skv: int, n_splits: int, span: int) -> None:
    if n_splits < 1 or span < TILE or span % TILE:
        raise ValueError(f"need n_splits >= 1 and span a positive multiple "
                         f"of {TILE}; got n_splits={n_splits}, span={span}")
    if n_splits * span < skv:
        raise ValueError(f"{n_splits} spans of {span} keys do not cover "
                         f"Skv={skv}")


def flash_decode_plain(q, k, v, kv_len, *, causal: bool, n_splits: int,
                       span: int):
    """The kernel's function in plain PyTorch: for each span s of keys
    [s * span, (s + 1) * span), the span-normalised fp32 partial
    o_part[b, h, s] = softmax over the span's live keys of q k^T, times v,
    and lse_part[b, h, s] = max + log(sum exp), or -1e30 and a zero partial
    for a span with no live key.  q (B, Sq, H, D) already scaled, k / v
    (B, Skv, KV, D), kv_len (B,) int32.  Returns ((B, H, S, Sq, D),
    (B, H, S, Sq)) fp32."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    _check_split(skv, n_splits, span)
    pad = n_splits * span - skv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    mask = attention_mask(b, sq, skv, causal=causal, kv_len=kv_len,
                          device=q.device)
    mask = torch.nn.functional.pad(mask, (0, pad))        # (B, Sq, S*span)
    qg = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)          # (B,KV,G,Sq,Skv')
    s = s.reshape(b, kvh, g, sq, n_splits, span)
    live = mask.reshape(b, 1, 1, sq, n_splits, span)
    s = s.masked_fill(~live, EMPTY_SPAN_LSE)
    m = s.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(-1)                                          # (B,KV,G,Sq,S)
    o = torch.einsum("bhgqsk,bskhd->bhgqsd", p,
                     vf.reshape(b, n_splits, span, kvh, d))
    lsafe = torch.where(l == 0, 1.0, l)
    o = o / lsafe[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(lsafe), EMPTY_SPAN_LSE)
    o_part = o.reshape(b, h, sq, n_splits, d).permute(0, 1, 3, 2, 4)
    lse_part = lse.reshape(b, h, sq, n_splits).permute(0, 1, 3, 2)
    return o_part.contiguous(), lse_part.contiguous()


def _launch(q, k, v, kv_len, causal, n_splits, span, merged):
    """One launch of the kernel: the partials, and with `merged` their
    merge into (B, Sq, H, D) in q's dtype.  Returns (out or None, o_part,
    lse_part)."""
    b, sq, skv, h, kvh, d, strides = cuda_args(q, k, v, kv_len)
    _check_split(skv, n_splits, span)
    o_part = torch.empty((b, h, n_splits, sq, d), dtype=torch.float32,
                         device=q.device)
    lse_part = torch.empty((b, h, n_splits, sq), dtype=torch.float32,
                           device=q.device)
    out = counters = None
    if merged:
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        counters = _counters(q.device, b * kvh * -(-(h // kvh) * sq // ROWS))
    if o_part.numel():
        build.launch(
            "flash_decode", "flash_decode_partials", _ARGTYPES,
            torch.cuda.current_stream(q.device).cuda_stream,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            o_part.data_ptr(), lse_part.data_ptr(),
            None if out is None else out.data_ptr(),
            None if counters is None else counters.data_ptr(), b, sq, skv,
            h, kvh, d, strides, int(causal), n_splits, span,
            DTYPES[q.dtype],
            what=f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                 f"{n_splits} x {span}")
        global launches
        launches += 1
    return out, o_part, lse_part


def _checked(q, k, v, kv_len, what):
    if kv_len is None:
        raise ValueError(f"{what} needs kv_len")
    check_operands(q, k, v, kv_len)
    check_head_dim(q.shape[-1], HEAD_DIMS, what)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")


def flash_decode_partials(q, k, v, kv_len, *, causal: bool, n_splits: int,
                          span: int):
    """Split-KV partials of softmax(q k^T) v: q (B, Sq, H, D) already
    scaled, k / v (B, Skv, KV, D) in the engine layout, kv_len a (B,) int32
    tensor of live extents clamped to Skv (required: it also masks the key
    padding); causal queries right-align against kv_len.  ``span`` is a
    multiple of `TILE` and ``n_splits * span >= Skv`` (`ops.decode_splits`).
    Returns (o_part (B, H, n_splits, Sq, D), lse_part (B, H, n_splits,
    Sq)), both fp32.  A CPU tensor runs `flash_decode_plain`; a CUDA tensor
    launches the kernel (without its merge) and raises RuntimeError if it
    fails."""
    _checked(q, k, v, kv_len, "flash_decode_partials")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, causal=causal,
                                  n_splits=n_splits, span=span)
    return _launch(q, k, v, kv_len, causal, n_splits, span, False)[1:]


def flash_decode(q, k, v, kv_len, *, causal: bool, n_splits: int,
                 span: int):
    """Split-KV decode attention in one launch, with
    `flash_decode_partials`'s contract: returns (out (B, Sq, H, D) in q's
    dtype, o_part, lse_part), out the partials merged as `merge_plain`
    merges them, bit for bit.  A CPU tensor runs `flash_decode_plain` and
    `merge_plain`; a CUDA tensor launches the kernel and raises
    RuntimeError if it fails, or ValueError for more than
    `MERGE_MAX_SPLITS` splits."""
    _checked(q, k, v, kv_len, "flash_decode")
    if q.device.type == "cpu":
        o_part, lse_part = flash_decode_plain(q, k, v, kv_len, causal=causal,
                                              n_splits=n_splits, span=span)
        return merge_plain(o_part, lse_part, q.dtype), o_part, lse_part
    if n_splits > MERGE_MAX_SPLITS:
        raise ValueError(f"the kernel merges at most {MERGE_MAX_SPLITS} "
                         f"splits, got {n_splits}")
    return _launch(q, k, v, kv_len, causal, n_splits, span, True)


def combine(o_part, lse_part):
    """Log-sum-exp merge of split-KV partials: o_part (B, H, S, Sq, D) and
    lse_part (B, H, S, Sq), fp32, with the -1e30 empty-span sentinel ->
    (B, H, Sq, D) fp32.  Exact up to rounding: each partial is its span's
    normalised sum, so weighting by exp(lse_s - max lse) recovers the
    softmax over all spans.  Rows whose spans are all empty merge to exact
    0 (zero partials over a finite denominator)."""
    m = lse_part.amax(2, keepdim=True)                    # (B, H, 1, Sq)
    alpha = torch.exp(lse_part - m)                       # (B, H, S, Sq)
    denom = alpha.sum(2)                                  # (B, H, Sq)
    num = (o_part * alpha[..., None]).sum(2)              # (B, H, Sq, D)
    return num / denom[..., None]


def merge_plain(o_part, lse_part, dtype):
    """The kernel's merge in plain PyTorch: `combine`, as (B, Sq, H, D) in
    `dtype` (a transposed view for fp32)."""
    return combine(o_part, lse_part).transpose(1, 2).to(dtype)
