"""Grouped flash-attention forward on Hopper.

Replaces ``repro/kernels/flash_attention.py``'s ``_flash_kernel`` (launched
by ``_forward``) on the LM serving path: prefill chunks, whole-prompt
prefill and decode against a short extent.  The kernel is hand-written CUDA
C++ in ``csrc/flash_attention.cu`` (its per-tile update shared with the
decode kernel in ``csrc/attention_common.cuh``), built by ``build.py`` and
called through ctypes.  The source's header says what bounds it on the
H100 and what its design does about that.

  flash_attention_fwd     the kernel wrapper
  flash_attention_plain   its plain PyTorch version

Both take q already scaled by sm_scale (``kernels/ops.py::attention``
folds the scale into q in fp32) and read q (B, Sq, H, D), k / v
(B, Skv, KV, D) in the engine layout, with no transpose or padding.  The
wrapper checks device, dtype and shape, allocates the output and launches
on PyTorch's current stream for a CUDA tensor; only for a CPU tensor does
it run the plain version.  A failed build or launch raises; nothing falls
back.  `launches` counts the kernel's launches and moves nowhere else.

Forward only: the lse output and the backward kernels (dQ, dK / dV) come
with LM training.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the head dims the kernels are instantiated for

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
STRIDES = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = [_P] * 5 + [_I] * 6 + [STRIDES, _I, _I]


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def flash_attention_plain(q, k, v, kv_len=None, *, causal: bool = True):
    """The kernel's function in plain PyTorch: softmax(q k^T) v with fp32
    statistics, grouped KV, keys at or past the (B,) ``kv_len`` masked,
    causal queries right-aligned against the live extent, exact 0 for rows
    with no live key; q is already scaled.  Returns q's dtype."""
    return flash_attention_ref(q, k, v, causal=causal, sm_scale=1.0,
                               kv_len=kv_len)


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


def cuda_args(q, k, v, kv_len) -> tuple:
    """The pointer, size and stride arguments both C entry points share,
    after checking what the kernels need on the card: one CUDA device,
    a head dim they are instantiated for, rows contiguous along D."""
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dim")
    if kv_len is not None and not kv_len.is_contiguous():
        raise ValueError("kv_len must be contiguous")
    strides = (ctypes.c_longlong * 9)(
        *(s for t in (q, k, v) for s in t.stride()[:3]))
    return (b, sq, k.shape[1], h, k.shape[2], d, strides)


def flash_attention_fwd(q, k, v, kv_len=None, *, causal: bool = True):
    """softmax(q k^T) v for q (B, Sq, H, D) and k, v (B, Skv, KV, D), q
    already scaled; head h reads kv-head h // (H // KV).

    ``kv_len``: None or a (B,) int32 tensor of live extents clamped to Skv
    (`ops.normalize_kv_len`); causal queries right-align against it (else
    against Skv).  Returns (B, Sq, H, D) contiguous in q's dtype, fp32
    softmax statistics.  A CPU tensor runs `flash_attention_plain`; a CUDA
    tensor launches the kernel and raises RuntimeError if it fails.
    """
    check_operands(q, k, v, kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not "
                         f"{q.device}")
    b, sq, skv, h, kvh, d, strides = cuda_args(q, k, v, kv_len)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if o.numel():
        build.launch(
            "flash_attention", "flash_attention_fwd", _ARGTYPES,
            torch.cuda.current_stream(q.device).cuda_stream,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), o.data_ptr(),
            b, sq, skv, h, kvh, d, strides, int(causal), DTYPES[q.dtype],
            what=f"q {tuple(q.shape)}, k {tuple(k.shape)}")
        global launches
        launches += 1
    return o
