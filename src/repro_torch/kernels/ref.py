"""Plain oracles for the port's kernels (PyTorch port of
``repro/kernels/ref.py``).

Deliberately the most obvious formulation: fp32 products and fp32
accumulation through ``torch.matmul`` on fp32 copies of the operands, no
tiling, so a disagreement points at the kernel, not the oracle.  On a CUDA
device the engine turns TF32 off (core/engine.py), so these are true fp32
products.  The attention oracle comes with the LM slice.
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
