"""Attention on the compute engine: GQA and MLA (DeepSeek) (PyTorch port
of ``repro/models/attention.py``).

Every path, prefill and decode, dispatches the engine's `attention` op with
the compact grouped K/V (B, S, KV, hd): the op reads the shared kv-head per
query-head group, so no H-broadcast is ever made.  On the `cuda` backend a
decode-shaped dispatch (short query, deep cache) takes the split-KV decode
kernel, the rest the flash-attention forward kernel.  The projections are
fused GEMMs on the engine (bias in the epilogue).

MLA's prefill materialises per-head K / V from the latent and dispatches
the op as MHA at head dim nope + rope (192 at deepseek-v2-lite), V
zero-padded to that width and cut after the op; its decode is the absorbed
form, multi-query attention over the latent cache (one kv-head of width
lora + rope, 576, values c_kv zero-padded to it, the scale 1/sqrt(nope +
rope)), with W_uk and W_uv applied by two engine einsums, which the `cuda`
backend runs on the bmm kernel.

`blockwise_attention`, the streaming-softmax formulation that never makes
the S x S scores, is the JAX module's A/B oracle (``kernel_attention=False``
in the forward paths); it takes Dv != Dh natively.  It runs on `ref` and
`eager` only: its per-block einsums are not batched GEMMs, so the `cuda`
backend has no kernel for them, and it refuses it by name.  The JAX
module's sharding hints (``hints.shard``, ``shard_mode``) steer a
partitioner across a mesh and are no-ops on one device; the port leaves
them out.
"""
from __future__ import annotations

import torch

from repro_torch.core import ComputeEngine
from repro_torch.models.common import norm_init, rmsnorm, rope_apply

_NEG = -1e30


def blockwise_attention(engine: ComputeEngine, q, k, v, *, causal: bool,
                        n_q_chunks: int = 8, kv_chunk: int = 1024):
    """q (B, Sq, KV, G, Dh); k (B, Skv, KV, Dh), v (B, Skv, KV, Dv) ->
    (B, Sq, KV, G, Dv) in q's dtype (JAX's ``blockwise_attention``).

    Outer loop: `n_q_chunks` query chunks, each with its causal key extent
    trimmed; inner loop over key blocks of `kv_chunk` carrying (m, l, acc)
    in fp32, queries right-aligned against Skv, rows with no live key
    exact 0.  Scale 1/sqrt(Dh).  NotImplementedError on the `cuda`
    backend."""
    if engine.backend == "cuda":
        raise NotImplementedError(
            "blockwise_attention runs on the 'ref' and 'eager' backends "
            "only: its per-block einsums are not batched GEMMs, so backend "
            "'cuda' has no kernel for them (the model paths take the "
            "attention op, kernel_attention=True)")
    b, sq, kvh, g, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    q_offset = skv - sq
    qc = max(sq // n_q_chunks, 1)
    n_q = sq // qc
    if n_q * qc != sq:
        raise ValueError(f"{sq} query rows do not split into chunks of {qc}")
    sm = 1.0 / dh ** 0.5
    dev = q.device
    outs = []
    for i in range(n_q):
        qi = q[:, i * qc:(i + 1) * qc]
        extent = q_offset + (i + 1) * qc if causal else skv
        # a chunk with no live key (extent <= 0) reads one key, masked
        kvc = min(kv_chunk, max(extent, 1))
        n_kv = max(-(-extent // kvc), 1)
        m = torch.full((b, kvh, g, qc), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, qc, dv), dtype=torch.float32,
                          device=dev)
        q_idx = (q_offset + i * qc
                 + torch.arange(qc, device=dev))[:, None]
        for j in range(n_kv):
            # the last block's start is clamped to Skv - kvc (JAX's
            # dynamic_slice); the lower bound keeps each key in one block
            start = min(j * kvc, skv - kvc)
            kj, vj = k[:, start:start + kvc], v[:, start:start + kvc]
            s = engine.einsum("bqhgd,bkhd->bhgqk", qi, kj,
                              out_dtype=torch.float32) * sm
            k_idx = start + torch.arange(kvc, device=dev)[None, :]
            valid = (k_idx >= j * kvc) & (k_idx < extent)
            if causal:
                valid = valid & (k_idx <= q_idx)
            s = torch.where(valid, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s > _NEG * 0.5, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + engine.einsum(
                "bhgqk,bkhd->bhgqd", p, vj, out_dtype=torch.float32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qc, KV, G, Dv)
    return torch.cat(outs, dim=1).to(q.dtype)


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
                return_kv: bool = False, n_q_chunks: int = 8,
                kernel_attention: bool = True):
    """x (B, S, D) -> (B, S, D), full sequence (prefill).  With
    ``return_kv`` also returns the layer's cache entry {"k", "v"}, each
    (B, S, KV, hd).  ``kernel_attention=False`` takes `blockwise_attention`
    (the A/B oracle, `n_q_chunks` query chunks) in place of the op."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(engine, p, x, cos, sin, cfg)
    if kernel_attention:
        y = engine.attention(q, k, v, causal=cfg.causal)
    else:
        kvh = cfg.n_kv_heads
        y = blockwise_attention(
            engine, q.reshape(b, s, kvh, cfg.n_heads // kvh, -1), k, v,
            causal=cfg.causal, n_q_chunks=n_q_chunks)
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


# ------------------------------------------------------------- MLA layer ---

def mla_init(generator: torch.Generator, cfg, device=None) -> dict:
    """wq (D, H (nope + rope)), w_dkv (D, lora + rope), the latent's rms
    norm, w_uk (lora, H nope), w_uv (lora, H v) and wo (H v, D); the JAX
    package's initialisation rules (its numbers differ)."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, lora, vd, _ = _mla_split(cfg)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device) / fan_in ** 0.5

    return {"wq": normal((d, h * (nope + rope_d)), d),
            "w_dkv": normal((d, lora + rope_d), d),
            "kv_norm": norm_init("rms", lora, device),
            "w_uk": normal((lora, h * nope), lora),
            "w_uv": normal((lora, h * vd), lora),
            "wo": normal((h * vd, d), h * vd)}


def _mla_split(cfg):
    return (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank,
            cfg.v_head_dim, cfg.n_heads)


def _mla_latent(engine, p, x, cos, sin, cfg):
    """The projections both MLA paths share: q_nope, q_rope (RoPE'd) of
    (B, S, H, ·), the normed latent c_kv (B, S, lora) and the RoPE'd shared
    key k_rope (B, S, 1, rope)."""
    b, s, _ = x.shape
    nope, rope_d, lora, _, h = _mla_split(cfg)
    q = engine.matmul(x, p["wq"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], rope_apply(q[..., nope:], cos, sin)
    dkv = engine.matmul(x, p["w_dkv"])
    c_kv = rmsnorm(dkv[..., :lora], p["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = rope_apply(dkv[..., lora:][:, :, None, :], cos, sin)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(engine: ComputeEngine, p: dict, x, cos, sin, cfg, *,
                n_q_chunks: int = 8, return_cache: bool = False,
                kernel_attention: bool = True):
    """MLA prefill: x (B, S, D) -> (B, S, D), per-head K / V made from the
    latent.  q_full / k_full are (B, S, H, nope + rope), k_rope broadcast
    over the heads; with ``kernel_attention`` the op runs them as MHA
    (KV == H) against V zero-padded to nope + rope (exact: softmax weights
    times zero columns), the pad cut after the op; else
    `blockwise_attention` takes V at its own width.  With
    ``return_cache`` also returns the layer's cache entry {"c_kv" (B, S,
    lora), "k_rope" (B, S, rope)}."""
    b, s, _ = x.shape
    nope, rope_d, _, vd, h = _mla_split(cfg)
    q_nope, q_rope, c_kv, k_rope = _mla_latent(engine, p, x, cos, sin, cfg)
    k_nope = engine.matmul(c_kv, p["w_uk"]).reshape(b, s, h, nope)
    v = engine.matmul(c_kv, p["w_uv"]).reshape(b, s, h, vd)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], dim=-1)
    if kernel_attention:
        v_pad = torch.cat([v, v.new_zeros(b, s, h, nope + rope_d - vd)],
                          dim=-1)
        y = engine.attention(q_full, k_full, v_pad, causal=True)[..., :vd]
    else:
        y = blockwise_attention(engine, q_full[:, :, :, None], k_full, v,
                                causal=True, n_q_chunks=n_q_chunks)
    out = engine.matmul(y.reshape(b, s, h * vd), p["wo"])
    if return_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    return out


def mla_decode(engine: ComputeEngine, p: dict, x, cache: dict, pos, cos,
               sin, cfg):
    """Absorbed MLA decode of a chunk of C new tokens (C == 1 one-token
    decode, C > 1 a chunk with right-aligned causality between its
    tokens).

    x (B, C, D); cache {"c_kv" (B, S_max, lora), "k_rope" (B, S_max,
    rope)}, written in place at rows [pos, pos + C).  W_uk is absorbed
    into the query (``bqhn,rhn->bqhr``) and W_uv applied after the
    attention (``bqhr,rhv->bqhv``), both engine einsums; the attention is
    multi-query over the latent: q_cat (B, C, H, lora + rope) against
    kv_cat = [c_kv, k_rope] (B, S_max, 1, lora + rope) and v_pad = [c_kv,
    0], ``kv_len = pos + C``, the scale 1/sqrt(nope + rope), not the op's
    default 1/sqrt(lora + rope).  On `cuda` that dispatch takes the
    split-KV decode kernel at head dim lora + rope (576) when it is
    decode-shaped (C <= 8 against a cache of 256 rows or more,
    `kernels.ops.use_decode_formulation`), else the flash forward at 576:
    a step against a shorter cache (the slot engine's default 128 rows),
    causal or not, and every chunk of more than 8 tokens.  Returns
    (y (B, C, D), cache)."""
    b, c, _ = x.shape
    nope, rope_d, lora, vd, h = _mla_split(cfg)
    q_nope, q_rope, c_kv, k_rope = _mla_latent(engine, p, x, cos, sin, cfg)
    cc = cache_write(cache["c_kv"], c_kv, pos)
    cr = cache_write(cache["k_rope"], k_rope[:, :, 0, :], pos)
    q_abs = engine.einsum("bqhn,rhn->bqhr", q_nope,
                          p["w_uk"].reshape(lora, h, nope),
                          out_dtype=torch.float32)
    q_cat = torch.cat([q_abs, q_rope.float()], dim=-1)
    kv_cat = torch.cat([cc, cr], dim=-1)[:, :, None, :]
    v_pad = torch.cat([cc, torch.zeros_like(cr)], dim=-1)[:, :, None, :]
    kv_len = torch.as_tensor(pos, device=x.device) + c
    ctx = engine.attention(q_cat.to(kv_cat.dtype), kv_cat, v_pad,
                           causal=c > 1, sm_scale=1.0 / (nope + rope_d) ** 0.5,
                           kv_len=kv_len)[..., :lora]
    y = engine.einsum("bqhr,rhv->bqhv", ctx, p["w_uv"].reshape(lora, h, vd),
                      out_dtype=torch.float32)
    y = y.reshape(b, c, h * vd).to(x.dtype)
    return engine.matmul(y, p["wo"]), {"c_kv": cc, "k_rope": cr}
