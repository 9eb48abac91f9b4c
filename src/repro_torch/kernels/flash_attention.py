"""Grouped flash attention on Hopper, forward and backward.

Replaces ``repro/kernels/flash_attention.py``'s three TPU kernels:
``_flash_kernel`` (launched by ``_forward``, with and without its lse
residual) on the LM serving and training paths, and the backward's
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``.  The kernels are
hand-written CUDA C++ in ``csrc/flash_attention.cu`` (its per-tile update
shared with the decode kernel in ``csrc/attention_common.cuh``) and
``csrc/flash_attention_bwd.cu``, built by ``build.py`` and called through
ctypes.  Each source's header says what bounds it on the H100 and what
its design does about that.

  flash_attention_fwd        the forward; ``return_lse=True`` also returns
                             the per-row softmax residual lse (B, H, Sq)
  flash_attention_plain      its plain PyTorch version
  flash_attention_bwd_dq     dQ = (P o (dO V^T - Delta)) K
                             (flash_attention_bwd_dq_plain)
  flash_attention_bwd_dkv    dK = (P o (dO V^T - Delta))^T Q, dV = P^T dO
                             (flash_attention_bwd_dkv_plain)
  FlashAttention             the autograd Function of the JAX ``_flash``
                             custom VJP

All take q already scaled by sm_scale (``kernels/ops.py::attention``
folds the scale into q in fp32, a differentiable multiply outside the
Function) and read q (B, Sq, H, D), k / v (B, Skv, KV, D) and dO
(B, Sq, H, D) in the engine layout, with no transpose or padding; dK / dV
come out compact (B, Skv, KV, D).  A wrapper checks device, dtype and
shape, allocates its outputs and launches on PyTorch's current stream for
a CUDA tensor; only for a CPU tensor does it run the plain version.  A
failed build or launch raises; nothing falls back.  Each kernel has its
own launch count (`launches`, `launches_lse`, `launches_dq`,
`launches_dkv`), moved only where the kernel is launched.

The forward launches under a `FwdPlan`, its query rows and threads per
block and lanes per query row: `PLANS` are the instantiated plans,
`plans_at` those a head dim admits (a plan's lanes must split the head
dim and its fp32 block fit in shared memory: at 80 and 112 the 32-lane
plan is out, at 192 and 576 it is the only one) and `plan_for` picks one
from the shape.  The forward is instantiated at head dims `FWD_HEAD_DIMS`
(32, 64, 80, 112, 128, MLA's prefill 192 and its latent 576, where K and
V stream through 32-key half tiles), the backward kernels at
`BWD_HEAD_DIMS` (32, 64, 80, 112, 128 and 192: hubert-xlarge's 80,
zamba2's 112 and MLA's prefill 192 included) and the decode kernel at
``flash_decode.HEAD_DIMS`` (32, 64, 112, 128 and MLA's latent 576);
each wrapper refuses another head dim by name, on the CPU as on the
card.  The dQ kernel
launches under a `BwdPlan`, its query rows per block: `BWD_PLANS` are
the instantiated plans, `bwd_plans_at` those a head dim admits (a plan's
fp32 block must fit in shared memory: at 192 the 16-row plan alone) and
`bwd_plan_for` picks one from the shape.
Every plan gives every output the same bits (one fmaf chain per element
in a fixed order, ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``), so a plan is a matter of speed only.
The dK / dV kernel has one launch shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_mask, flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FWD_HEAD_DIMS = (32, 64, 80, 112, 128, 192, 576)  # the forward kernel's
BWD_HEAD_DIMS = (32, 64, 80, 112, 128, 192)  # dQ's and dK / dV's
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448  # bytes of shared memory one block may use
KEY_TILE = 64  # keys of a K / V tile of the kernels


class FwdPlan(NamedTuple):
    """A plan of the forward kernel: its query rows and threads per block
    and the lanes that hold one row (8, 16 or 32)."""
    rows: int
    threads: int
    lanes: int


# The instantiated forward plans; a plan's index is its id in
# csrc/flash_attention.cu.
PLANS = (FwdPlan(64, 256, 8), FwdPlan(128, 256, 8), FwdPlan(8, 256, 32))


class BwdPlan(NamedTuple):
    """A plan of the dQ kernel: its query rows per block (16 or 64)."""
    rows: int


# The instantiated backward plans; a plan's index is its id in
# csrc/flash_attention_bwd.cu.
BWD_PLANS = (BwdPlan(64), BwdPlan(16))

launches = 0      # flash_attention_fwd, serving forward (no lse)
launches_lse = 0  # flash_attention_fwd with the lse (the training forward)
launches_dq = 0   # flash_attention_bwd_dq
launches_dkv = 0  # flash_attention_bwd_dkv

_P, _I = ctypes.c_void_p, ctypes.c_int
STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {  # entry point -> (library, argument types before the stream)
    "flash_attention_fwd": ("flash_attention",
                            [_P] * 5 + [_I] * 6 + [STRIDES, _I, _I, _I]),
    "flash_attention_fwd_lse": ("flash_attention",
                                [_P] * 6 + [_I] * 6 + [STRIDES, _I, _I, _I]),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               [_P] * 8 + [_I] * 6 + [STRIDES, _I, _I, _I]),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                [_P] * 9 + [_I] * 6 + [STRIDES, _I, _I]),
}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches, launches_lse, launches_dq, launches_dkv
    launches = launches_lse = launches_dq = launches_dkv = 0


def launch_counts() -> dict[str, int]:
    """The launch counts by kernel name."""
    return {"flash_attention": launches, "flash_attention_lse": launches_lse,
            "flash_attention_bwd_dq": launches_dq,
            "flash_attention_bwd_dkv": launches_dkv}


def _grouped_scores(q, k):
    """fp32 scores (B, KV, G, Sq, Skv) of the grouped layout: query head
    h = kv * G + g against kv-head kv, no broadcast."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d).float()
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())


def _live(q, k, kv_len, causal, relative=False):
    """(B or 1, 1, 1, Sq, Skv) bool mask of the live (query, key) pairs,
    broadcast against the grouped scores."""
    b, sq = q.shape[:2]
    return attention_mask(b, sq, k.shape[1], causal=causal, kv_len=kv_len,
                          device=q.device, relative=relative)[:, None, None]


def flash_attention_plain(q, k, v, kv_len=None, *, causal: bool = True,
                          return_lse: bool = False, relative: bool = False):
    """The kernel's function in plain PyTorch: softmax(q k^T) v with fp32
    statistics, grouped KV, keys at or past the (B,) ``kv_len`` masked,
    causal queries right-aligned against the live extent, exact 0 for rows
    with no live key; q is already scaled.  ``relative``: kv_len is one
    span's relative extent, which may exceed Skv or be <= 0
    (`ref.attention_mask`).  Returns q's dtype; with ``return_lse`` also
    the fp32 (B, H, Sq) logsumexp of each row's live scores, 0 for a row
    with no live key."""
    o = flash_attention_ref(q, k, v, causal=causal, sm_scale=1.0,
                            kv_len=kv_len, relative=relative)
    if not return_lse:
        return o
    live = _live(q, k, kv_len, causal, relative)
    s = _grouped_scores(q, k).masked_fill(~live, float("-inf"))
    lse = torch.where(live.any(-1), torch.logsumexp(s, dim=-1), 0.0)
    b, sq, h, _ = q.shape
    return o, lse.reshape(b, h, sq)


def _bwd_tiles(q, k, v, do, lse, delta, kv_len, causal):
    """The backward's fp32 P = exp(s - lse) on the live pairs (exact 0
    elsewhere) and dS = P o (dO V^T - Delta), (B, KV, G, Sq, Skv), with
    the grouped dO (B, Sq, KV, G, D)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    rows = (b, kvh, g, sq, 1)
    p = torch.where(_live(q, k, kv_len, causal),
                    torch.exp(_grouped_scores(q, k) - lse.reshape(rows)),
                    0.0)
    dog = do.reshape(b, sq, kvh, g, d).float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    return p, p * (dp - delta.reshape(rows)), dog


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, kv_len=None, *,
                                 causal: bool = True):
    """The dQ kernel's function in plain PyTorch, fp32 arithmetic:
    dQ = dS K with dS = P o (dO V^T - Delta), P = exp(s - lse) on the live
    pairs and exact 0 elsewhere; q is already scaled, lse and delta fp32
    (B, H, Sq).  Returns (B, Sq, H, D) in q's dtype."""
    _, ds, _ = _bwd_tiles(q, k, v, do, lse, delta, kv_len, causal)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, kv_len=None, *,
                                  causal: bool = True):
    """The dK / dV kernel's function in plain PyTorch, fp32 arithmetic:
    dK = dS^T Q and dV = P^T dO, the G query heads of a group summed, as
    `flash_attention_bwd_dq_plain`.  Returns compact (B, Skv, KV, D) in
    k's and v's dtype."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    p, ds, dog = _bwd_tiles(q, k, v, do, lse, delta, kv_len, causal)
    qg = q.reshape(b, sq, kvh, h // kvh, d).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def check_operands(q, k, v, kv_len) -> None:
    """What both attention kernels take: q (B, Sq, H, D) and k / v
    (B, Skv, KV, D) of one float32 or bfloat16 dtype with H % KV == 0, a
    (B,) int32 kv_len or None.  Raises ValueError / TypeError."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Skv, KV, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch, head dim or head grouping")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len is not None and (kv_len.shape != (b,)
                               or kv_len.dtype != torch.int32):
        raise ValueError(f"kv_len must be a ({b},) int32 tensor; got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")


def check_head_dim(d: int, dims: tuple, kernel: str) -> None:
    """ValueError naming `kernel` and head dim `d` unless the kernel is
    instantiated at it (`dims`)."""
    if d not in dims:
        raise ValueError(f"{kernel} is instantiated for head dims {dims}, "
                         f"not head dim {d}")


def cuda_args(q, k, v, kv_len) -> tuple:
    """The pointer, size and stride arguments the C entry points share,
    after checking what the kernels need on the card: one CUDA device,
    rows contiguous along D (each wrapper checks its kernel's head dims
    first, `check_head_dim`)."""
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    b, sq, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dim")
    if kv_len is not None and not kv_len.is_contiguous():
        raise ValueError("kv_len must be contiguous")
    strides = (ctypes.c_longlong * 9)(
        *(s for t in (q, k, v) for s in t.stride()[:3]))
    return (b, sq, k.shape[1], h, k.shape[2], d, strides)


def _launch(entry: str, q, *args, what: str) -> None:
    lib, argtypes = _SIGNATURES[entry]
    build.launch(lib, entry, argtypes,
                 torch.cuda.current_stream(q.device).cuda_stream, *args,
                 what=what)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_card(name: str, q) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version);
    ValueError for any other device."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


def _smem_ld(d: int, dtype) -> tuple[int, int]:
    """(element size, row stride in elements) of a staged operand row of
    head dim `d`: the row padded by 16 bytes, as ``ld`` in the kernels."""
    size = dtype.itemsize
    return size, d + 16 // size


def fwd_smem_bytes(d: int, plan: FwdPlan, dtype=torch.float32) -> int:
    """Shared memory of one forward block (``FwdSmem`` in
    csrc/flash_attention.cu): the plan's q rows and two stages of a K and
    a V tile, or, where one fp32 stage of a K and a V tile would not fit
    in `MAX_SMEM` (head dim 576), two 32-key half tiles that K and V
    stream through (one rule for both dtypes); rows of head dim `d`
    padded by 16 bytes."""
    size, ld = _smem_ld(d, dtype)
    _, ld32 = _smem_ld(d, torch.float32)
    halves = (plan.rows + 2 * KEY_TILE) * ld32 * 4 > MAX_SMEM
    return (plan.rows + (1 if halves else 4) * KEY_TILE) * ld * size


def plans_at(d: int) -> tuple[FwdPlan, ...]:
    """The forward plans instantiated at head dim `d`: those whose lanes
    split it evenly and whose fp32 block fits in `MAX_SMEM` (one rule for
    both dtypes; every plan at 32, 64 and 128; at 80 and 112 the two 8-lane
    plans, 10 and 14 columns a lane; at 192 the 32-lane plan, 6 columns a
    lane, alone: the 8-lane plans' fp32 blocks need 250,880 and 301,056
    bytes; at 576 the 32-lane plan, 18 columns a lane, alone: 167,040
    bytes in half tiles, the 8-lane plans' 296,960 and 445,440)."""
    return tuple(p for p in PLANS if d % p.lanes == 0
                 and fwd_smem_bytes(d, p) <= MAX_SMEM)


def plan_for(b: int, sq: int, h: int, kv: int, d: int | None = None
             ) -> FwdPlan:
    """The forward's plan for b sequences of sq query rows, h query heads
    over kv kv-heads (of head dim d, when given): 128-row blocks when those
    give every SM a block, else 64-row blocks when those cover half the
    SMs, else 8-row blocks with a row on a whole warp (`time_attention.py`
    times every plan: 8-row blocks were fastest at the 64-token serving
    chunk at batch 1 and 4, 64-row ones at a 512-token prompt, 128-row ones
    at the training shapes), or 64-row blocks where d does not admit a
    32-lane row (`plans_at`; head dims 80 and 112), and always the 8-row
    plan where d admits no other (192 and 576).  For speed only: every
    plan gives the same bits."""
    admitted = PLANS if d is None else plans_at(d)
    rows = (h // kv) * sq
    if PLANS[1] in admitted and b * kv * -(-rows // 128) >= SMS:
        return PLANS[1]
    if PLANS[0] in admitted and (2 * b * kv * -(-rows // 64) >= SMS
                                 or PLANS[2] not in admitted):
        return PLANS[0]
    return PLANS[2]


def _plan_id(plan, plans) -> int:
    """The kernels' id of `plan` (a plan or its tuple) in `plans`;
    ValueError when it is not instantiated."""
    plan = tuple(plan)
    if plan not in plans:
        raise ValueError(f"plan must be one of {plans}, got {plan}")
    return plans.index(plan)


def flash_attention_fwd(q, k, v, kv_len=None, *, causal: bool = True,
                        return_lse: bool = False, plan=None,
                        relative: bool = False):
    """softmax(q k^T) v for q (B, Sq, H, D) and k, v (B, Skv, KV, D), q
    already scaled; head h reads kv-head h // (H // KV).

    ``kv_len``: None or a (B,) int32 tensor of live extents clamped to Skv
    (`ops.normalize_kv_len`); causal queries right-align against it (else
    against Skv).  With ``relative`` it is one span's relative extent
    (`ops.attention_partial`): any value, not clamped, the causal diagonal
    aligned against it and the live keys ending at Skv; the kernel caps
    each row's end at Skv, which changes nothing for kv_len <= Skv.  Returns (B, Sq, H, D) contiguous in q's dtype, fp32
    softmax statistics.  With ``return_lse`` (the training launch) returns
    ``(o, lse)``, lse the fp32 (B, H, Sq) per-row m + log l in the scaled
    score space, 0 for a row with no live key; o has the bits of the
    launch without it.  `plan` is one of `PLANS` (default `plan_for` the
    shape); any plan gives the same bits, and one that is not instantiated
    raises ValueError.  A CPU tensor runs `flash_attention_plain`; a CUDA
    tensor launches the kernel and raises RuntimeError if it fails.  Head
    dims: `FWD_HEAD_DIMS`, under a plan of `plans_at` the head dim.
    """
    check_operands(q, k, v, kv_len)
    b, sq, h, d = q.shape
    check_head_dim(d, FWD_HEAD_DIMS, "flash_attention_fwd")
    plan_id = _plan_id(plan_for(b, sq, h, k.shape[2], d)
                       if plan is None else plan, PLANS)
    if PLANS[plan_id] not in plans_at(d):
        raise ValueError(f"plan {PLANS[plan_id]} is not instantiated at "
                         f"head dim {d} (its {PLANS[plan_id].lanes} lanes "
                         f"do not split a row, or its block does not fit "
                         f"in shared memory); use one of {plans_at(d)}")
    if not _on_card("flash_attention_fwd", q):
        return flash_attention_plain(q, k, v, kv_len, causal=causal,
                                     return_lse=return_lse,
                                     relative=relative)
    b, sq, skv, h, kvh, d, strides = cuda_args(q, k, v, kv_len)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel():
        global launches, launches_lse
        entry = "flash_attention_fwd_lse" if return_lse else \
            "flash_attention_fwd"
        outs = (o, lse) if return_lse else (o,)
        _launch(entry, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _ptr(kv_len), *(t.data_ptr() for t in outs),
                b, sq, skv, h, kvh, d, strides, int(causal), DTYPES[q.dtype],
                plan_id, what=f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                              f"plan {PLANS[plan_id]}")
        if return_lse:
            launches_lse += 1
        else:
            launches += 1
    return (o, lse) if return_lse else o


def bwd_smem_bytes(d: int, plan: BwdPlan, dtype=torch.float32) -> int:
    """Shared memory of one dQ block (``DqSmem`` in
    csrc/flash_attention_bwd.cu): the plan's q and dO rows, two stages of a
    K and a V tile of `KEY_TILE` keys, and dS transposed in fp32."""
    size, ld = _smem_ld(d, dtype)
    return ((2 * plan.rows + 4 * KEY_TILE) * ld * size
            + KEY_TILE * (plan.rows + 8) * 4)


@functools.cache
def bwd_plans_at(d: int) -> tuple[BwdPlan, ...]:
    """The dQ plans instantiated at head dim `d`: those whose fp32 block
    fits in `MAX_SMEM` (one rule for both dtypes; both plans up to 128, at
    192 the 16-row plan alone: the 64-row plan's fp32 block needs 319,488
    bytes)."""
    return tuple(p for p in BWD_PLANS if bwd_smem_bytes(d, p) <= MAX_SMEM)


def bwd_plan_for(b: int, sq: int, h: int, kv: int, d: int) -> BwdPlan:
    """The backward's plan for b sequences of sq query rows, h query heads
    over kv kv-heads of head dim d: 64-row dQ blocks when those give every
    SM a block, else 16-row blocks, four times as many (`time_attention.py
    --bwd` times both: 16 rows were faster up to 112 64-row blocks, 64 rows
    from 140 on), and always 16-row blocks where d admits no other
    (`bwd_plans_at`; 192).  For speed only: every plan gives the same
    bits."""
    blocks = b * kv * -(-(h // kv) * sq // 64)
    if BWD_PLANS[0] in bwd_plans_at(d) and blocks >= SMS:
        return BWD_PLANS[0]
    return BWD_PLANS[1]


def _check_bwd(q, do, lse, delta, kernel: str) -> None:
    b, sq, h, d = q.shape
    check_head_dim(d, BWD_HEAD_DIMS, kernel)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must be {q.dtype} {tuple(q.shape)}; got "
                         f"{do.dtype} {tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, h, sq)}; got "
                             f"{t.dtype} {tuple(t.shape)}")


def _bwd_args(q, k, v, do, lse, delta, kv_len) -> tuple:
    """The C entry points' operand pointers and sizes, after the checks
    the kernels need on the card (lse / delta contiguous on q's device,
    dO contiguous along D)."""
    b, sq, skv, h, kvh, d, _ = cuda_args(q, k, v, kv_len)
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if do.stride(3) != 1:
        raise ValueError("do must be contiguous along the head dim")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("lse and delta must be contiguous")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, do) for s in t.stride()[:3]))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(kv_len))
    return ptrs, (b, sq, skv, h, kvh, d, strides)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_len=None, *,
                           causal: bool = True, plan=None):
    """dQ (B, Sq, H, D) in q's dtype, for q already scaled: the forward's
    operands, dO (B, Sq, H, D), its lse and Delta = rowsum(dO o O), fp32
    (B, H, Sq).  `plan` is one of `BWD_PLANS` (default `bwd_plan_for` the
    shape); any plan gives the same bits, and one that is not
    instantiated, or not at this head dim (`bwd_plans_at`), raises
    ValueError.  A CPU tensor runs `flash_attention_bwd_dq_plain`; a CUDA
    tensor launches the kernel and raises RuntimeError if it fails."""
    check_operands(q, k, v, kv_len)
    _check_bwd(q, do, lse, delta, "flash_attention_bwd_dq")
    b, sq, h, d = q.shape
    plan_id = _plan_id(bwd_plan_for(b, sq, h, k.shape[2], d)
                       if plan is None else plan, BWD_PLANS)
    admitted = bwd_plans_at(d)
    if BWD_PLANS[plan_id] not in admitted:
        raise ValueError(f"dQ plan {BWD_PLANS[plan_id]} is not instantiated "
                         f"at head dim {d} (its block does not fit in "
                         f"shared memory); use one of {admitted}")
    if not _on_card("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, kv_len,
                                            causal=causal)
    if k.shape[1] == 0:
        return torch.zeros_like(q)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, kv_len)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        global launches_dq
        _launch("flash_attention_bwd_dq", q, *ptrs, dq.data_ptr(), *dims,
                int(causal), DTYPES[q.dtype], plan_id,
                what=f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                     f"plan {BWD_PLANS[plan_id]}")
        launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_len=None, *,
                            causal: bool = True):
    """(dK, dV), each compact (B, Skv, KV, D) in k's dtype: the G query
    heads of a group are reduced inside the kernel, in a fixed order with
    no atomics.  Operands as `flash_attention_bwd_dq`; a CPU tensor runs
    `flash_attention_bwd_dkv_plain`."""
    check_operands(q, k, v, kv_len)
    _check_bwd(q, do, lse, delta, "flash_attention_bwd_dkv")
    if not _on_card("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             kv_len, causal=causal)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, kv_len)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel():
        global launches_dkv
        _launch("flash_attention_bwd_dkv", q, *ptrs, dk.data_ptr(),
                dv.data_ptr(), *dims, int(causal), DTYPES[q.dtype],
                what=f"q {tuple(q.shape)}, k {tuple(k.shape)}")
        launches_dkv += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Grouped flash attention with its gradient (``repro``'s ``_flash``
    custom VJP).

    ``FlashAttention.apply(q, k, v, kv_len, causal[, plan, bwd_plan])``,
    q already scaled; `plan` is the forward's and `bwd_plan` the dQ
    kernel's (each None: `plan_for` / `bwd_plan_for` the shape;
    ``kernels/ops.py::attention`` passes the registry's picks).
    The forward is the lse-emitting kernel and saves (q, k, v, kv_len, o,
    lse).  The backward computes Delta = rowsum(dO o O) in fp32 in PyTorch
    (as ``_flash_vjp_bwd``; a row with no live key has O = 0, so Delta = 0
    there) and launches the dQ kernel under `bwd_plan` and the dK / dV
    kernel.  kv_len, causal and the plans get no gradient.  A head dim the
    backward kernels lack (MLA's latent 576, which is never trained) is
    refused here, before the forward runs.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, plan=None, bwd_plan=None):
        check_head_dim(q.shape[-1], BWD_HEAD_DIMS, "flash_attention_bwd")
        o, lse = flash_attention_fwd(q, k, v, kv_len, causal=causal,
                                     return_lse=True, plan=plan or None)
        ctx.save_for_backward(q, k, v, kv_len, o, lse)
        ctx.causal, ctx.bwd_plan = causal, bwd_plan or None
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_len, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_len,
                                        causal=ctx.causal, plan=ctx.bwd_plan)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_len,
                                             causal=ctx.causal)
        return dq, dk, dv, None, None, None, None
