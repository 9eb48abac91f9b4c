"""Plain oracles for the port's kernels (PyTorch port of
``repro/kernels/ref.py``).

Deliberately the most obvious formulation: fp32 products and fp32
accumulation through ``torch.matmul`` on fp32 copies of the operands, no
tiling, so a disagreement points at the kernel, not the oracle.  On a CUDA
device the engine turns TF32 off (core/engine.py), so these are true fp32
products.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import apply_act


def matmul_ref(x, w, *, scale=None, shift=None, act: str = "linear",
               out_dtype=None):
    """Oracle for the fused GEMM engine: act((x @ w) * scale + shift).

    x: (M, K); w: (K, N); scale/shift: (N,) or None.  Accumulation is
    always fp32.
    """
    out_dtype = out_dtype or x.dtype
    acc = torch.matmul(x.float(), w.float())
    if scale is not None:
        acc = acc * scale.float()
    if shift is not None:
        acc = acc + shift.float()
    return apply_act(acc, act).to(out_dtype)


def bmm_ref(x, w, *, out_dtype=None):
    """Batched GEMM oracle: (B, M, K) @ (B, K, N), fp32 accumulation."""
    out_dtype = out_dtype or x.dtype
    return torch.bmm(x.float(), w.float()).to(out_dtype)


def attention_mask(b: int, sq: int, skv: int, *, causal: bool, kv_len,
                   device, relative: bool = False) -> torch.Tensor:
    """(B or 1, Sq, Skv) bool mask of the live (query, key) pairs: keys at or
    past ``kv_len`` (None, an int, or a scalar or (B,) tensor; clamped to
    Skv) are masked per batch row, and causal queries right-align against
    the live extent (kv_len when given, else Skv).  With ``relative`` the
    extent is one span's share of a longer key axis
    (`ops.attention_partial`): it may exceed Skv or be <= 0, is not
    clamped, and causal queries right-align against it as given; keys are
    live below min(row end, Skv).  For kv_len <= Skv both modes agree."""
    kj = torch.arange(skv, device=device)
    qi = torch.arange(sq, device=device)
    if kv_len is None:
        mask = torch.ones((1, sq, skv), dtype=torch.bool, device=device)
        if causal:
            mask = mask & (kj[None, :] <= qi[:, None] + (skv - sq))[None]
        return mask
    kvl = torch.as_tensor(kv_len, dtype=torch.int64, device=device)
    kvl = kvl.reshape(-1).expand(b)
    if not relative:
        kvl = torch.clamp(kvl, max=skv)
    mask = (kj[None, None] < kvl[:, None, None]).expand(b, sq, skv)
    if causal:
        mask = mask & (kj[None, None]
                       <= qi[None, :, None] + (kvl[:, None, None] - sq))
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, sm_scale=None,
                        kv_len=None, relative: bool = False):
    """Oracle for the grouped attention kernels.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0: query head
    h = kv * G + g attends kv-head h // G (G = H // KV), read through a
    grouped einsum, never broadcast.  ``kv_len`` (None, an int, or a scalar
    or (B,) tensor) masks keys at or past it per batch row, clamped to Skv;
    causal queries right-align against kv_len when given, else Skv; rows
    with no live key return exact 0 (``relative``: kv_len is a span's
    relative extent, not clamped, see `attention_mask`).  Returns
    (B, Sq, H, D) in q.dtype, softmax in fp32.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qg = q.reshape(b, sq, kvh, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sm_scale
    mask = attention_mask(b, sq, skv, causal=causal, kv_len=kv_len,
                          device=q.device, relative=relative)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, :, None], p, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
