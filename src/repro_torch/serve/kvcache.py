"""KV-cache construction (PyTorch port of ``repro/serve/kvcache.py``, dense
part).

Attention caches store the compact grouped layout (B, S, KV, hd), the
engine `attention` op's native KV layout, consumed by prefill and decode
with no H-broadcast.  One entry per layer-program entry, each layer's
cache stacked under a leading layer axis:
``[{"k", "v": (n_layers, B, S_max, KV, hd)}]``.  The dtype follows the
engine's compute dtype (fp32 under fp32_strict, bf16 under mixed).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import stack_program


def cache_init(cfg, B: int, S_max: int, dtype=torch.float32,
               device=None) -> list[dict]:
    """Zeroed caches for `B` sequences of up to `S_max` rows."""
    shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros((n, *shape), dtype=dtype, device=device),
             "v": torch.zeros((n, *shape), dtype=dtype, device=device)}
            for _, n in stack_program(cfg)]

