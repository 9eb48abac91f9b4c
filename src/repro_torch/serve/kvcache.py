"""Cache construction (PyTorch port of ``repro/serve/kvcache.py``, dense and
mamba parts).

Attention caches store the compact grouped layout (B, S, KV, hd), the
engine `attention` op's native KV layout, consumed by prefill and decode
with no H-broadcast.  SSM caches are O(1) in the sequence length: the last
conv - 1 rows of the x, B and C projections and the (H, P, N) state.  One
entry per layer-program entry, each layer's cache stacked under a leading
layer axis:
``[{"k", "v": (n_layers, B, S_max, KV, hd)}]`` for a dense stack,
``[{"conv_x": (n_layers, B, conv - 1, d_inner), "conv_B", "conv_C":
(n_layers, B, conv - 1, G * N), "ssm": (n_layers, B, H, P, N)}]`` for a
mamba stack.  The dtype follows the engine's compute dtype (fp32 under
fp32_strict, bf16 under mixed).
"""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssm_cache_init
from repro_torch.models.transformer import stack_program


def cache_init(cfg, B: int, S_max: int, dtype=torch.float32,
               device=None) -> list[dict]:
    """Zeroed caches for `B` sequences of up to `S_max` rows."""
    out = []
    for kind, n in stack_program(cfg):
        if kind == "mamba":
            out.append({name: torch.stack([t] * n) for name, t in
                        ssm_cache_init(B, cfg, dtype, device).items()})
            continue
        shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
        out.append({"k": torch.zeros((n, *shape), dtype=dtype,
                                     device=device),
                    "v": torch.zeros((n, *shape), dtype=dtype,
                                     device=device)})
    return out
