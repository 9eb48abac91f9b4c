"""Error-feedback gradient compression (PyTorch port of
``repro/train/compression.py``).

int8 quantization with a per-tensor scale and an error-feedback
accumulator: the quantization residual is carried into the next step,
which preserves SGD convergence (Karimireddy et al., 2019).  In a
deployment with manual collectives this runs before the cross-node
all-reduce, cutting gradient traffic 4x (fp32 -> int8); on one card it
models that boundary: quantize -> dequantize, with the residual kept.

The non-quantization policy (core/precision.py) applies to parameters;
the gradient wire format is transient and does not touch stored precision.
Trees are flat name -> tensor dicts (`repro_torch.tree.flatten`).
"""
from __future__ import annotations

from typing import Mapping

import torch


def ef_compress(g, err):
    """One tensor: error-feedback int8 round trip.  Returns
    ``(g_hat, new_err)``, both fp32."""
    g32 = g.float() + (err if err is not None else 0.0)
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat, g32 - g_hat


def ef_init(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """fp32 zero residuals shaped like `params`."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def ef_compress_tree(grads: Mapping[str, torch.Tensor], err_tree=None):
    """`ef_compress` over every gradient: ``(g_hat tree, new error tree)``;
    a missing error tree starts at zero."""
    if err_tree is None:
        err_tree = ef_init(grads)
    outs = {k: ef_compress(g, err_tree[k]) for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})


def topk_compress(g, k_frac: float = 0.01):
    """Top-k magnitude sparsification: the k = max(1, k_frac * size)
    largest-magnitude entries of g in fp32, the rest 0 (reference
    implementation and tests)."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * k_frac))
    idx = torch.topk(flat.abs(), k).indices
    mask = torch.zeros_like(flat)
    mask[idx] = 1.0
    return (flat * mask).reshape(g.shape)
