"""Grouped-query attention on the compute engine (PyTorch port of the GQA
part of ``repro/models/attention.py``).

Every path, prefill and decode, dispatches the engine's `attention` op with
the compact grouped K/V (B, S, KV, hd): the op reads the shared kv-head per
query-head group, so no H-broadcast is ever made.  On the `cuda` backend a
decode-shaped dispatch (short query, deep cache) takes the split-KV decode
kernel, the rest the flash-attention forward kernel.  The projections are
fused GEMMs on the engine (bias in the epilogue).

MLA and the blockwise jnp oracle of the JAX module come with the other
model families.
"""
from __future__ import annotations

import torch

from repro_torch.core import ComputeEngine
from repro_torch.models.common import rope_apply


def gqa_init(generator: torch.Generator, cfg, device=None) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device) / fan_in ** 0.5

    p = {"wq": normal((d, h * hd), d), "wk": normal((d, kvh * hd), d),
         "wv": normal((d, kvh * hd), d), "wo": normal((h * hd, d), h * hd)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, device=device)
        p["bk"] = torch.zeros(kvh * hd, device=device)
        p["bv"] = torch.zeros(kvh * hd, device=device)
    return p


def _project_qkv(engine: ComputeEngine, p: dict, x, cos, sin, cfg):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = engine.matmul(x, p["wq"], shift=p.get("bq")).reshape(b, s, h, hd)
    k = engine.matmul(x, p["wk"], shift=p.get("bk")).reshape(b, s, kvh, hd)
    v = engine.matmul(x, p["wv"], shift=p.get("bv")).reshape(b, s, kvh, hd)
    if cos is not None:
        q, k = rope_apply(q, cos, sin), rope_apply(k, cos, sin)
    return q, k, v


def gqa_forward(engine: ComputeEngine, p: dict, x, cos, sin, cfg, *,
                return_kv: bool = False):
    """x (B, S, D) -> (B, S, D), full sequence (prefill).  With
    ``return_kv`` also returns the layer's cache entry {"k", "v"}, each
    (B, S, KV, hd)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(engine, p, x, cos, sin, cfg)
    y = engine.attention(q, k, v, causal=cfg.causal)
    out = engine.matmul(y.reshape(b, s, -1), p["wo"])
    if return_kv:
        return out, {"k": k, "v": v}
    return out


def cache_write(cache, new, pos):
    """Write the C rows of `new` (B, C, KV, hd) into `cache` (B, S, KV, hd)
    at rows [pos, pos + C), IN PLACE (the JAX version returns an updated
    copy), and return the cache.  `pos` is an int, a scalar or a (B,)
    tensor (each sequence at its own position).  A start past S - C is
    clamped to S - C, as ``jax.lax.dynamic_update_slice`` clamps it, so a
    write never leaves the cache."""
    b, s = cache.shape[:2]
    c = new.shape[1]
    start = torch.as_tensor(pos, device=cache.device).to(torch.int64)
    start = torch.clamp(start.reshape(-1, 1), 0, s - c)
    rows = (start + torch.arange(c, device=cache.device)).expand(b, c)
    batch = torch.arange(b, device=cache.device)[:, None]
    cache[batch, rows] = new.to(cache.dtype)
    return cache


def gqa_decode(engine: ComputeEngine, p: dict, x, cache: dict, pos, cos, sin,
               cfg):
    """Decode a chunk of C new tokens against a KV cache (C == 1 is one-token
    decode, C > 1 a chunked-prefill step).

    x (B, C, D); cache {"k", "v"} each (B, S_max, KV, hd), written in place
    at rows [pos, pos + C); pos an int, a scalar or a (B,) tensor of START
    positions.  Attention dispatches the grouped engine op against the
    whole cache buffer with ``kv_len = pos + C`` (unwritten rows masked);
    for C > 1 causal right-alignment against that extent keeps causality
    between the chunk's own tokens.  Returns (y (B, C, D), cache).
    """
    b, c, _ = x.shape
    q, k, v = _project_qkv(engine, p, x, cos, sin, cfg)
    ck = cache_write(cache["k"], k, pos)
    cv = cache_write(cache["v"], v, pos)
    kv_len = torch.as_tensor(pos, device=x.device) + c
    y = engine.attention(q.to(ck.dtype), ck, cv, causal=c > 1,
                         kv_len=kv_len)
    y = y.reshape(b, c, -1).to(x.dtype)
    return engine.matmul(y, p["wo"]), {"k": ck, "v": cv}
