"""The LM assembled per ArchConfig: the dense GQA, Mamba2 SSM, MoE (GQA
and MLA) and hybrid (zamba2) families and the modality frontends (PyTorch
port of ``repro/models/transformer.py``, with its ``_embed_inputs`` and
``_shared_block``).

The layer program is static, from the config: ``[("dense", n_layers)]``
for the dense, vision (``vlm``) and audio families, ``[("mamba",
n_layers)]`` for the SSM family, ``[("gqa_moe", n_layers)]`` for a MoE
config without MLA (llama4-scout), ``[("mla_dense", first_dense_layers),
("mla_moe", the rest)]`` for one with MLA (deepseek-v2-lite-16b: 1 and
26; its RoPE tables are qk_rope_dim wide), and for the hybrid ``[("zamba_super",
n_super)]`` plus a ``("mamba", tail)`` entry when ``attn_every`` does not
divide the layers (zamba2-7b: 13 super entries of 6 mamba layers, then 3
mamba layers).  A super entry runs its ``attn_every`` mamba layers, then
the ONE shared attention + MLP block (``params["shared"]``, the same
weights at every entry), which reads concat(hidden, the embedding of the
call's tokens) through an rms norm and a 2d -> d projection and adds its
d -> d output back.  A vision config prepends its projected patch
embeddings to the text embeddings; an audio config projects its frame
embeddings in place of a token lookup (it keeps the unused ``embed``
table, as JAX's ``init_params`` does) and, being encoder-only
(``causal=False``), attends both ways with no decode step.  The JAX
package stacks each program entry's layers under leading layer axes and
scans over them; the port keeps one parameter dict per layer in
``params["layers"]``, in program order (a super entry's layers row-major:
entry i's layer j is ``layers[i * attn_every + j]``), and loops (PyTorch
runs eagerly, so there is nothing to trace).
`convert.lm_params_from_jax` turns a JAX tree into this form.

Parameters (plain dicts of tensors)::

    {"embed": {"tokens": (V_padded, D)}, "final_norm": {...},
     "frontend": {...},                          # vlm and audio only
     "layers": [{"norm1", "attn", "norm2", "mlp"}, ...],   # dense
     "layers": [{"norm1", "attn", "norm2", "moe"}, ...],   # gqa_moe
     "layers": [{"norm1", "attn", "norm2", "mlp" or "moe"}, ...],  # mla_*
     "layers": [{"norm", "mixer"}, ...],                   # mamba, hybrid
     "shared": {"norm_in", "win", "norm1", "attn", "norm2", "mlp",
                "wout"},                                   # hybrid only
     "lm_head": {"w": (D, V_padded)}}           # untied configs only

A tied head is the embedding's transpose, ``embed.t()``: a view that the
GEMM kernel reads in place, so the head neither copies the table per call
nor keeps a second copy of it (544 MB at qwen2-0.5b).  Caches are a list
aligned with the layer program, as in JAX:
``{"k", "v": (n_layers, B, S, KV, hd)}`` for a dense or gqa_moe
stack, ``{"c_kv": (n_layers, B, S, lora), "k_rope": (n_layers, B, S,
rope)}`` for an MLA one (the latent, 576 values a token and layer at
deepseek-v2-lite), ``{"conv_x", "conv_B", "conv_C": (n_layers, B, conv - 1, C),
"ssm": (n_layers, B, H, P, N)}`` for a mamba stack, O(1) in the sequence
length, and for a super entry ``{"mamba": {the mamba leaves, (n,
attn_every, B, ...)}, "shared": {"k", "v": (n, B, S, KV, hd)}}``.
`loss_fn` is the training loss: the forward under autograd, each layer
(each super entry, shared block included) recomputed in the backward
(``remat``, the JAX ``jax.checkpoint`` of the scanned body), the chunked
cross-entropy through the (tied) head and, for a MoE stack, the mean of
the layers' load-balance losses.  ``kernel_attention=False`` (in
`forward_hidden`, `loss_fn`, `forward_prefill`) takes the blockwise
attention oracle (`attention.blockwise_attention`, `n_q_chunks` query
chunks, on `ref` and `eager`) in place of the attention op, as in JAX.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import ComputeEngine
from repro_torch.models import attention as attn
from repro_torch.models import frontend as fe
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (chunked_cross_entropy, embed_init,
                                       embed_lookup, norm_apply, norm_init,
                                       rmsnorm, rope_table)
from repro_torch.models.mlp import mlp_forward, mlp_init
from repro_torch.tree import flatten


def stack_program(cfg) -> list[tuple[str, int]]:
    """The static layer program of every family: dense (also under the
    vision and audio frontends), SSM, MoE (GQA, or MLA with its first
    dense layers) and hybrid."""
    if cfg.family in ("dense", "vlm", "audio"):
        return [("dense", cfg.n_layers)]
    if cfg.family == "ssm":
        return [("mamba", cfg.n_layers)]
    if cfg.family == "moe" and cfg.is_mla:
        prog = ([("mla_dense", cfg.first_dense_layers)]
                if cfg.first_dense_layers else [])
        return prog + [("mla_moe", cfg.n_layers - cfg.first_dense_layers)]
    if cfg.family == "moe":
        return [("gqa_moe", cfg.n_layers)]
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        tail = cfg.n_layers - n_super * cfg.attn_every
        return [("zamba_super", n_super)] + ([("mamba", tail)] if tail
                                             else [])
    raise NotImplementedError(
        f"the {cfg.family!r} family ({cfg.name}) is not ported yet: the "
        f"port runs dense GQA (with the vision and audio frontends), GQA "
        f"MoE, mamba and hybrid stacks only")


def entry_layers(kind: str, n: int, cfg) -> int:
    """The layer dicts of a program entry of `n`: a super entry holds
    ``attn_every`` mamba layers each."""
    return n * cfg.attn_every if kind == "zamba_super" else n


def _program(cfg, params: dict) -> list[tuple[str, int, list]]:
    """(kind, n, the entry's layer dicts) of each program entry, the dicts
    cut from ``params["layers"]`` in program order."""
    out, first = [], 0
    for kind, n in stack_program(cfg):
        count = entry_layers(kind, n, cfg)
        out.append((kind, n, params["layers"][first:first + count]))
        first += count
    return out


def _layer_init(kind: str, generator, cfg, device) -> dict:
    if kind in ("mamba", "zamba_super"):
        return {"norm": norm_init(cfg.norm, cfg.d_model, device),
                "mixer": ssm_mod.ssm_init(generator, cfg, device)}
    init = attn.mla_init if kind.startswith("mla") else attn.gqa_init
    lp = {"norm1": norm_init(cfg.norm, cfg.d_model, device),
          "attn": init(generator, cfg, device),
          "norm2": norm_init(cfg.norm, cfg.d_model, device)}
    if kind in ("gqa_moe", "mla_moe"):
        lp["moe"] = moe_mod.moe_init(generator, cfg, device)
    else:
        lp["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act,
                             device)
    return lp


def _shared_block_init(generator, cfg, device) -> dict:
    """The hybrid's shared attention + MLP block (JAX's
    ``_shared_block_init``)."""
    d = cfg.d_model
    return {"norm_in": norm_init("rms", 2 * d, device),
            "win": torch.randn(2 * d, d, generator=generator,
                               device=device) / (2 * d) ** 0.5,
            "norm1": norm_init(cfg.norm, d, device),
            "attn": attn.gqa_init(generator, cfg, device),
            "norm2": norm_init(cfg.norm, d, device),
            "mlp": mlp_init(generator, d, cfg.d_ff, cfg.act, device),
            "wout": torch.randn(d, d, generator=generator,
                                device=device) / d ** 0.5}


def init_params(cfg, *, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the JAX package's initialisation rules (its
    numbers differ: this draws from `generator`, which lives on `device`)."""
    params = {"embed": embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                  device),
              "final_norm": norm_init(cfg.norm, cfg.d_model, device)}
    if cfg.frontend != "none":
        params["frontend"] = fe.frontend_init(generator, cfg, device)
    params["layers"] = [_layer_init(kind, generator, cfg, device)
                        for kind, n in stack_program(cfg)
                        for _ in range(entry_layers(kind, n, cfg))]
    if cfg.family == "hybrid":
        params["shared"] = _shared_block_init(generator, cfg, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": torch.randn(
            cfg.d_model, cfg.vocab_padded, generator=generator,
            device=device) / cfg.d_model ** 0.5}
    return params


def head_weight(params: dict, cfg):
    """The (D, V_padded) head weight: the untied ``lm_head``, or for a
    tied config the view ``embed.t()`` of the embedding table (no copy)."""
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].t()
    return params["lm_head"]["w"]


@functools.lru_cache(maxsize=32)
def param_counts(cfg) -> tuple[int, int]:
    """(total, active) parameter counts.  The shapes come from
    `init_params` on the ``meta`` device, so nothing is allocated at any
    width; active leaves out the routed-expert weights a token does not
    run (per token only top_k of the E experts), as in JAX."""
    params = init_params(cfg, generator=None, device="meta")
    total = sum(t.numel() for t in flatten(params).values())
    active = total
    if cfg.is_moe:
        e, k, d, f = (cfg.n_routed_experts, cfg.top_k, cfg.d_model,
                      cfg.moe_d_ff)
        n_moe = cfg.n_layers - cfg.first_dense_layers
        active -= n_moe * (e - k) * 3 * d * f
    return total, active


def _layer(kind, engine, cfg, lp, h, cos, sin, return_cache=False,
           attn_kw=None):
    """One layer of the program: (h, its cache entry or None, its MoE
    load-balance loss or None).  `attn_kw` ({"n_q_chunks",
    "kernel_attention"}) goes to the attention layer."""
    if kind == "mamba":
        m = ssm_mod.ssm_forward(
            engine, lp["mixer"],
            norm_apply(cfg.norm, lp["norm"], h, cfg.norm_eps), cfg,
            return_cache=return_cache)
        m, cache = m if return_cache else (m, None)
        return h + m, cache, None
    x = norm_apply(cfg.norm, lp["norm1"], h, cfg.norm_eps)
    if kind.startswith("mla"):
        a = attn.mla_forward(engine, lp["attn"], x, cos, sin, cfg,
                             return_cache=return_cache, **(attn_kw or {}))
    else:
        a = attn.gqa_forward(engine, lp["attn"], x, cos, sin, cfg,
                             return_kv=return_cache, **(attn_kw or {}))
    a, kv = a if return_cache else (a, None)
    h = h + a
    x = norm_apply(cfg.norm, lp["norm2"], h, cfg.norm_eps)
    if kind in ("gqa_moe", "mla_moe"):
        m, aux = moe_mod.moe_forward(engine, lp["moe"], x, cfg)
    else:
        m, aux = mlp_forward(engine, lp["mlp"], x, cfg.act), None
    return h + m, kv, aux


def _embed(engine, params, tokens):
    return embed_lookup(params["embed"], tokens,
                        engine.precision.compute_dtype)


def _embed_inputs(engine, cfg, params, tokens=None, patch_embeds=None,
                  frames=None):
    """The (B, S, D) input of the layer stack: the projected frames of an
    audio config; else the token embeddings, after the projected patch
    embeddings for a vision config (S = patches + text tokens)."""
    dt = engine.precision.compute_dtype
    if cfg.frontend == "audio":
        return fe.frontend_apply(engine, params["frontend"], frames.to(dt),
                                 cfg)
    h = _embed(engine, params, tokens)
    if cfg.frontend == "vision":
        v = fe.frontend_apply(engine, params["frontend"],
                              patch_embeds.to(dt), cfg)
        h = torch.cat([v, h], dim=1)
    return h


def _rope(cfg, positions):
    """The RoPE tables of a program that holds attention (for the hybrid,
    the shared block's; for MLA qk_rope_dim wide), (None, None) for a
    mamba stack."""
    if all(kind == "mamba" for kind, _ in stack_program(cfg)):
        return None, None
    dim = cfg.qk_rope_dim if cfg.is_mla else cfg.head_dim
    return rope_table(positions, dim, cfg.rope_theta)


def _shared_block(engine, cfg, sp, h, emb0, attend):
    """The hybrid's shared block (JAX's ``_shared_block``): h + wout(x)
    with x = win(rmsnorm(concat(h, emb0))) through pre-norm attention and
    the MLP, each added back.  ``attend(x)`` is the attention of the
    normed x: (its output, its cache entry or None).  Returns (h, the
    entry)."""
    x = rmsnorm(torch.cat([h, emb0], dim=-1), sp["norm_in"]["scale"],
                cfg.norm_eps)
    x = engine.matmul(x, sp["win"])
    a, kv = attend(norm_apply(cfg.norm, sp["norm1"], x, cfg.norm_eps))
    x = x + a
    x = x + mlp_forward(engine, sp["mlp"],
                        norm_apply(cfg.norm, sp["norm2"], x, cfg.norm_eps),
                        cfg.act)
    return h + engine.matmul(x, sp["wout"]), kv


def _stacked(entries: list):
    """The layers' cache entries of one program entry stacked under a
    leading layer axis, leaf by leaf (a nested entry stacks inside)."""
    first = entries[0]
    if isinstance(first, dict):
        return {name: _stacked([e[name] for e in entries])
                for name in first}
    return torch.stack(entries)


def _super_entry(engine, cfg, params, lps, h, emb0, cos, sin,
                 collect_caches, attn_kw):
    """One super entry of the hybrid: its mamba layers, then the shared
    block (its attention with `attn_kw`, as `_layer`'s).  Returns (h, its
    cache entry {"mamba": {leaf: (attn_every, B, ...)}, "shared": {"k",
    "v"}} or None)."""
    mamba = []
    for lp in lps:
        h, entry, _ = _layer("mamba", engine, cfg, lp, h, cos, sin,
                             return_cache=collect_caches)
        mamba.append(entry)

    def attend(x):
        a = attn.gqa_forward(engine, params["shared"]["attn"], x, cos, sin,
                             cfg, return_kv=collect_caches, **attn_kw)
        return a if collect_caches else (a, None)

    h, kv = _shared_block(engine, cfg, params["shared"], h, emb0, attend)
    if not collect_caches:
        return h, None
    return h, {"mamba": _stacked(mamba), "shared": kv}


def _forward(engine, cfg, params, h, *, collect_caches, remat,
             n_q_chunks=8, kernel_attention=True):
    """The full-sequence forward of the stack's input h (B, S, D),
    `_embed_inputs`'s: (final hidden (B, S, D), the program entries' caches
    (`forward_prefill`'s) or None, the summed MoE aux loss, a 0-d fp32
    tensor).  With ``remat`` each layer, and each super entry as one
    piece (JAX's ``jax.checkpoint(super_body)``), runs under
    ``torch.utils.checkpoint``.  `n_q_chunks` and `kernel_attention` go
    to every attention layer (`forward_hidden`)."""
    attn_kw = {"n_q_chunks": n_q_chunks,
               "kernel_attention": kernel_attention}
    cos, sin = _rope(cfg, torch.arange(h.shape[1], device=h.device))
    emb0 = h
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    for kind, n, layers in _program(cfg, params):
        entries = []
        if kind == "zamba_super":
            every = cfg.attn_every

            def block(lps, x):
                return _super_entry(engine, cfg, params, lps, x, emb0, cos,
                                    sin, collect_caches, attn_kw)

            for i in range(n):
                h, entry = run(block, layers[i * every:(i + 1) * every], h)
                entries.append(entry)
        else:
            def layer(lp, x, kind=kind):
                return _layer(kind, engine, cfg, lp, x, cos, sin,
                              return_cache=collect_caches, attn_kw=attn_kw)

            for lp in layers:
                h, entry, aux = run(layer, lp, h)
                entries.append(entry)
                if aux is not None:
                    aux_total = aux_total + aux
        if collect_caches:
            caches.append(_stacked(entries))
    h = norm_apply(cfg.norm, params["final_norm"], h, cfg.norm_eps)
    return h, caches if collect_caches else None, aux_total


def forward_hidden(engine: ComputeEngine, cfg, params: dict, *,
                   tokens=None, patch_embeds=None, frames=None,
                   remat: bool = False, n_q_chunks: int = 8,
                   kernel_attention: bool = True):
    """Full-sequence forward to (final hidden states (B, S, D), the summed
    MoE load-balance loss of the layers, a 0-d fp32 tensor: 0 for a stack
    without MoE layers); tokens (B, S_text) int, with patch_embeds (B, T,
    frontend_dim) for a vision config, or frames (B, S, frontend_dim) in
    their place for an audio config.  With ``remat`` each layer (each
    super entry of the hybrid) runs under ``torch.utils.checkpoint``: its
    activations are not kept for the backward, which recomputes them (the
    same values, so the same gradients; only the layer inputs stay
    alive).  ``kernel_attention=False`` takes the blockwise attention
    oracle in `n_q_chunks` query chunks (`ref` and `eager` only)."""
    h = _embed_inputs(engine, cfg, params, tokens, patch_embeds, frames)
    h, _, aux = _forward(engine, cfg, params, h, collect_caches=False,
                         remat=remat, n_q_chunks=n_q_chunks,
                         kernel_attention=kernel_attention)
    return h, aux


def loss_fn(engine: ComputeEngine, cfg, params: dict, batch: dict, *,
            aux_coef: float = 0.01, remat: bool = True, ce_chunk: int = 512,
            n_q_chunks: int = 8, kernel_attention: bool = True):
    """Mean token cross-entropy of a training batch ``{"tokens",
    "labels"}``, each (B, S) int (with ``patch_embeds`` for a vision
    config, whose text tokens are then S - T, or ``frames`` in place of
    tokens for an audio config), plus ``aux_coef`` times the mean MoE
    load-balance loss over the MoE layers when the stack has any.  On
    `cuda` a mamba layer's SSD under grad takes the einsum form the JAX
    package trains through (the SSD kernel is inference only).

    The forward dispatches the same engine ops as serving (on `cuda` the
    GEMM and attention kernels, differentiable through `GemmFused` and
    `FlashAttention`), so training and inference share one set of
    numerics; the head is `head_weight` (a tied head reads the embedding
    in place).  ``remat`` recomputes each layer in the backward, the JAX
    ``jax.checkpoint`` of the layer body.  ``kernel_attention=False``
    takes the blockwise attention oracle (`forward_hidden`).
    """
    h, aux = forward_hidden(engine, cfg, params, tokens=batch.get("tokens"),
                            patch_embeds=batch.get("patch_embeds"),
                            frames=batch.get("frames"), remat=remat,
                            n_q_chunks=n_q_chunks,
                            kernel_attention=kernel_attention)
    ce = chunked_cross_entropy(engine, h, head_weight(params, cfg),
                               batch["labels"], vocab_real=cfg.vocab_size,
                               chunk=ce_chunk)
    n_moe = sum(n for kind, n in stack_program(cfg) if "moe" in kind)
    return ce + aux_coef * aux / n_moe if n_moe else ce


def forward_prefill(engine: ComputeEngine, cfg, params: dict, *,
                    tokens=None, patch_embeds=None, frames=None,
                    collect_caches: bool = True, n_q_chunks: int = 8,
                    kernel_attention: bool = True):
    """Full-sequence forward (inputs as `forward_hidden`'s) that also
    collects the caches: returns (hidden (B, S, D), caches), the caches a
    list aligned with the layer program, each entry's layers stacked under
    leading layer axes ({"k", "v"} for dense and gqa_moe, {"c_kv",
    "k_rope"} for the MLA kinds, {"conv_x", "conv_B", "conv_C", "ssm"}
    for mamba, {"mamba", "shared"} for a super entry; see the module
    docstring), or (hidden, None) without ``collect_caches``.  A MoE
    layer's aux loss is dropped, as in JAX."""
    h = _embed_inputs(engine, cfg, params, tokens, patch_embeds, frames)
    h, caches, _ = _forward(engine, cfg, params, h,
                            collect_caches=collect_caches, remat=False,
                            n_q_chunks=n_q_chunks,
                            kernel_attention=kernel_attention)
    return h, caches


def _mamba_step(engine, cfg, lp, h, cache: dict):
    """One mamba layer's one-token decode; `cache` holds views of the
    layer's rows of the stacked caches, written in place."""
    x = norm_apply(cfg.norm, lp["norm"], h, cfg.norm_eps)
    m, new = ssm_mod.ssm_decode(engine, lp["mixer"], x, cache, cfg)
    for name, t in new.items():
        cache[name].copy_(t)
    return h + m


def decode_hidden(engine: ComputeEngine, cfg, params: dict, caches: list,
                  token, pos):
    """Decode a chunk of C new tokens against the caches.

    token: (B, C) int; C == 1 is one-token decode, C > 1 a chunked-prefill
    step (attention stacks only: a program that holds a mamba layer
    decodes strictly one token).  pos: an int, a scalar, or a (B,) tensor
    of per-sequence START positions; the chunk occupies rows [pos, pos +
    C) of the attention caches (mamba layers have no positions and ignore
    it; the hybrid's shared block writes its K / V at pos).  The caches
    are written in place (each layer's rows of the stacked tensors).  The
    hybrid's shared block reads the embedding of `token`, as JAX's
    ``decode_hidden`` does.
    Returns (hidden (B, C, D), caches).
    """
    prog = _program(cfg, params)
    c = token.shape[1]
    h = _embed(engine, params, token)
    if c != 1 and any(kind in ("mamba", "zamba_super")
                      for kind, _, _ in prog):
        raise ValueError(f"mamba decode takes one token per step, got {c}")
    emb0 = h
    cos = sin = start = None
    if any(kind != "mamba" for kind, _, _ in prog):
        start = torch.as_tensor(pos, device=h.device).to(torch.int64)
        ar = torch.arange(c, device=h.device)
        # (C,) positions for a shared start, (B, C) for per-sequence starts
        positions = start + ar if start.dim() == 0 else start[:, None] + ar
        cos, sin = _rope(cfg, positions)
    for (kind, n, layers), cache in zip(prog, caches):
        if kind == "mamba":
            for i, lp in enumerate(layers):
                h = _mamba_step(engine, cfg, lp, h,
                                {name: t[i] for name, t in cache.items()})
            continue
        if kind == "zamba_super":
            every, sp = cfg.attn_every, params["shared"]
            for i in range(n):
                for j, lp in enumerate(layers[i * every:(i + 1) * every]):
                    h = _mamba_step(engine, cfg, lp, h,
                                    {name: t[i, j] for name, t
                                     in cache["mamba"].items()})
                kv = {"k": cache["shared"]["k"][i],
                      "v": cache["shared"]["v"][i]}
                h, _ = _shared_block(
                    engine, cfg, sp, h, emb0,
                    lambda x, kv=kv: attn.gqa_decode(engine, sp["attn"], x,
                                                     kv, start, cos, sin,
                                                     cfg))
            continue
        step = attn.mla_decode if kind.startswith("mla") else attn.gqa_decode
        for i, lp in enumerate(layers):
            x = norm_apply(cfg.norm, lp["norm1"], h, cfg.norm_eps)
            a, _ = step(engine, lp["attn"], x,
                        {name: t[i] for name, t in cache.items()}, start,
                        cos, sin, cfg)
            h = h + a
            x = norm_apply(cfg.norm, lp["norm2"], h, cfg.norm_eps)
            if kind in ("gqa_moe", "mla_moe"):
                # each row's C new tokens are one routing group, as in JAX
                h = h + moe_mod.moe_forward(engine, lp["moe"], x, cfg)[0]
            else:
                h = h + mlp_forward(engine, lp["mlp"], x, cfg.act)
    h = norm_apply(cfg.norm, params["final_norm"], h, cfg.norm_eps)
    return h, caches
