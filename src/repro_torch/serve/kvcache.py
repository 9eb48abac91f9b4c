"""Cache construction (PyTorch port of ``repro/serve/kvcache.py``).

Attention caches store the compact grouped layout (B, S, KV, hd), the
engine `attention` op's native KV layout, consumed by prefill and decode
with no H-broadcast.  SSM caches are O(1) in the sequence length: the last
conv - 1 rows of the x, B and C projections and the (H, P, N) state.  One
entry per layer-program entry, each layer's cache stacked under a leading
layer axis:
``[{"k", "v": (n_layers, B, S_max, KV, hd)}]`` for a dense stack,
``{"c_kv": (n_layers, B, S_max, kv_lora_rank), "k_rope": (n_layers, B,
S_max, qk_rope_dim)}`` for each MLA entry (the latent, not per-head K /
V),
``[{"conv_x": (n_layers, B, conv - 1, d_inner), "conv_B", "conv_C":
(n_layers, B, conv - 1, G * N), "ssm": (n_layers, B, H, P, N)}]`` for a
mamba stack, and for a hybrid super entry of n ``{"mamba": {the mamba
leaves, (n, attn_every, B, ...)}, "shared": {"k", "v": (n, B, S_max, KV,
hd)}}`` (JAX's ``cache_struct``), its tail's mamba entry after it.  The
dtype follows the engine's compute dtype (fp32 under fp32_strict, bf16
under mixed).  `slot_rows` and `copy_prefill` are the one place outside
`cache_init` that reads this layout.
"""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssm_cache_init
from repro_torch.models.transformer import stack_program


def _kv(lead: tuple, cfg, B: int, S_max: int, dtype, device) -> dict:
    shape = (*lead, B, S_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _latent(lead: tuple, cfg, B: int, S_max: int, dtype, device) -> dict:
    return {"c_kv": torch.zeros((*lead, B, S_max, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, B, S_max, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def _mamba(lead: tuple, cfg, B: int, dtype, device) -> dict:
    return {name: torch.zeros((*lead, *t.shape), dtype=dtype, device=device)
            for name, t in ssm_cache_init(B, cfg, dtype, device).items()}


def cache_init(cfg, B: int, S_max: int, dtype=torch.float32,
               device=None) -> list[dict]:
    """Zeroed caches for `B` sequences of up to `S_max` rows."""
    out = []
    for kind, n in stack_program(cfg):
        if kind == "mamba":
            out.append(_mamba((n,), cfg, B, dtype, device))
        elif kind == "zamba_super":
            out.append({"mamba": _mamba((n, cfg.attn_every), cfg, B, dtype,
                                        device),
                        "shared": _kv((n,), cfg, B, S_max, dtype, device)})
        elif kind in ("mla_dense", "mla_moe"):
            out.append(_latent((n,), cfg, B, S_max, dtype, device))
        else:
            out.append(_kv((n,), cfg, B, S_max, dtype, device))
    return out


def slot_rows(cfg, caches: list, s, kv_rows: int = 0) -> list:
    """Views of slot `s` (an index or a slice of the batch) of `caches`:
    every mamba leaf's rows (the super entries' and the tail's) and, given
    `kv_rows`, the first `kv_rows` rows of every K / V leaf (the super
    entries' shared block's, a dense stack's, an MLA entry's c_kv and
    k_rope), in one order for any caches of the program."""
    rows = []
    for (kind, _), entry in zip(stack_program(cfg), caches):
        if kind == "mamba":
            rows += [t[:, s] for t in entry.values()]
            continue
        if kind == "zamba_super":
            rows += [t[:, :, s] for t in entry["mamba"].values()]
            entry = entry["shared"]
        if kv_rows:
            rows += [t[:, s, :kv_rows] for t in entry.values()]
    return rows


def copy_prefill(cfg, buf: list, caches: list, n: int) -> None:
    """Copy the caches of a prefill of `n` positions into `buf` (from
    `cache_init`, the same batch): every mamba leaf whole, the K / V rows
    [0, n)."""
    everyone = slice(None)
    for dst, src in zip(slot_rows(cfg, buf, everyone, n),
                        slot_rows(cfg, caches, everyone, n)):
        dst.copy_(src)
