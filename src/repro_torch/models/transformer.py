"""The LM assembled per ArchConfig, dense GQA family (PyTorch port of the
dense path of ``repro/models/transformer.py``).

The layer program is static, from the config: ``[("dense", n_layers)]``.
The JAX package stacks each program entry's layers under one leading layer
axis and scans over it; the port keeps one parameter dict per layer in
``params["layers"]`` and loops (PyTorch runs eagerly, so there is nothing
to trace).  `convert.lm_params_from_jax` turns a JAX tree into this form.

Parameters (plain dicts of tensors)::

    {"embed": {"tokens": (V_padded, D)}, "final_norm": {...},
     "layers": [{"norm1", "attn", "norm2", "mlp"}, ...],
     "lm_head": {"w": (D, V_padded)}}           # untied configs only

A tied head is the embedding's transpose, ``embed.t()``: a view that the
GEMM kernel reads in place, so the head neither copies the table per call
nor keeps a second copy of it (544 MB at qwen2-0.5b).  Caches are a list
aligned with the layer program, ``[{"k", "v": (n_layers, B, S, KV, hd)}]``,
as in JAX.  `loss_fn` is the training loss: the forward under autograd,
each layer recomputed in the backward (``remat``, the JAX
``jax.checkpoint`` of the scanned layer body) and the chunked
cross-entropy through the (tied) head.
MoE, MLA, SSM, hybrid and the modality frontends come with their model
code; their families raise NotImplementedError here.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import ComputeEngine
from repro_torch.models import attention as attn
from repro_torch.models.common import (chunked_cross_entropy, embed_init,
                                       embed_lookup, norm_apply, norm_init,
                                       rope_table)
from repro_torch.models.mlp import mlp_forward, mlp_init


def stack_program(cfg) -> list[tuple[str, int]]:
    """The static layer program; only the dense family is ported."""
    if cfg.family == "dense":
        return [("dense", cfg.n_layers)]
    raise NotImplementedError(
        f"the {cfg.family!r} family ({cfg.name}) is not ported yet: the "
        f"port runs dense GQA stacks only")


def init_params(cfg, *, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the JAX package's initialisation rules (its
    numbers differ: this draws from `generator`, which lives on `device`)."""
    stack_program(cfg)
    params = {"embed": embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                  device),
              "final_norm": norm_init(cfg.norm, cfg.d_model, device),
              "layers": [{"norm1": norm_init(cfg.norm, cfg.d_model, device),
                          "attn": attn.gqa_init(generator, cfg, device),
                          "norm2": norm_init(cfg.norm, cfg.d_model, device),
                          "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff,
                                          cfg.act, device)}
                         for _ in range(cfg.n_layers)]}
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


def _dense_layer(engine, cfg, lp, h, cos, sin, return_kv=False):
    a = attn.gqa_forward(engine, lp["attn"],
                         norm_apply(cfg.norm, lp["norm1"], h, cfg.norm_eps),
                         cos, sin, cfg, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = h + a
    m = mlp_forward(engine, lp["mlp"],
                    norm_apply(cfg.norm, lp["norm2"], h, cfg.norm_eps),
                    cfg.act)
    return h + m, kv


def _embed(engine, params, tokens):
    return embed_lookup(params["embed"], tokens,
                        engine.precision.compute_dtype)


def forward_hidden(engine: ComputeEngine, cfg, params: dict, *, tokens,
                   remat: bool = False):
    """Full-sequence forward to the final hidden states (B, S, D); tokens
    (B, S) int.  With ``remat`` each layer runs under
    ``torch.utils.checkpoint``: its activations are not kept for the
    backward, which recomputes them (the same values, so the same
    gradients; only the layer inputs stay alive)."""
    if not remat:
        return forward_prefill(engine, cfg, params, tokens=tokens,
                               collect_caches=False)[0]
    stack_program(cfg)
    h = _embed(engine, params, tokens)
    cos, sin = rope_table(torch.arange(h.shape[1], device=h.device),
                          cfg.head_dim, cfg.rope_theta)

    def layer(lp, x):
        return _dense_layer(engine, cfg, lp, x, cos, sin)[0]

    for lp in params["layers"]:
        h = checkpoint(layer, lp, h, use_reentrant=False,
                       preserve_rng_state=False)
    return norm_apply(cfg.norm, params["final_norm"], h, cfg.norm_eps)


def loss_fn(engine: ComputeEngine, cfg, params: dict, batch: dict, *,
            remat: bool = True, ce_chunk: int = 512):
    """Mean token cross-entropy of a training batch ``{"tokens",
    "labels"}``, each (B, S) int, dense family only.

    The forward dispatches the same engine ops as serving (on `cuda` the
    GEMM and attention kernels, differentiable through `GemmFused` and
    `FlashAttention`), so training and inference share one set of
    numerics; the head is `head_weight` (a tied head reads the embedding
    in place).  ``remat`` recomputes each layer in the backward, the JAX
    ``jax.checkpoint`` of the layer body.  The JAX ``n_q_chunks`` and
    ``kernel_attention=False`` belong to its blockwise attention oracle,
    which the port does not have yet, so they are left out; the port has
    no MoE family, so there is no aux loss.
    """
    h = forward_hidden(engine, cfg, params, tokens=batch["tokens"],
                       remat=remat)
    return chunked_cross_entropy(engine, h, head_weight(params, cfg),
                                 batch["labels"], vocab_real=cfg.vocab_size,
                                 chunk=ce_chunk)


def forward_prefill(engine: ComputeEngine, cfg, params: dict, *, tokens,
                    collect_caches: bool = True):
    """Full-sequence forward that also collects the caches: returns
    (hidden (B, S, D), [{"k", "v": (n_layers, B, S, KV, hd)}]), or
    (hidden, None) without ``collect_caches``."""
    stack_program(cfg)
    h = _embed(engine, params, tokens)
    cos, sin = rope_table(torch.arange(h.shape[1], device=h.device),
                          cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for lp in params["layers"]:
        h, kv = _dense_layer(engine, cfg, lp, h, cos, sin,
                             return_kv=collect_caches)
        if collect_caches:
            ks.append(kv["k"])
            vs.append(kv["v"])
    h = norm_apply(cfg.norm, params["final_norm"], h, cfg.norm_eps)
    if not collect_caches:
        return h, None
    return h, [{"k": torch.stack(ks), "v": torch.stack(vs)}]


def decode_hidden(engine: ComputeEngine, cfg, params: dict, caches: list,
                  token, pos):
    """Decode a chunk of C new tokens against the caches.

    token: (B, C) int; C == 1 is one-token decode, C > 1 a chunked-prefill
    step.  pos: an int, a scalar, or a (B,) tensor of per-sequence START
    positions; the chunk occupies rows [pos, pos + C).  The caches are
    written in place (each layer's rows of the stacked tensors).
    Returns (hidden (B, C, D), caches).
    """
    (_, n), = stack_program(cfg)
    c = token.shape[1]
    h = _embed(engine, params, token)
    start = torch.as_tensor(pos, device=h.device).to(torch.int64)
    ar = torch.arange(c, device=h.device)
    # (C,) positions for a shared start, (B, C) for per-sequence starts
    positions = start + ar if start.dim() == 0 else start[:, None] + ar
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    cache = caches[0]
    for i, lp in enumerate(params["layers"][:n]):
        x = norm_apply(cfg.norm, lp["norm1"], h, cfg.norm_eps)
        a, _ = attn.gqa_decode(engine, lp["attn"], x,
                               {"k": cache["k"][i], "v": cache["v"][i]},
                               start, cos, sin, cfg)
        h = h + a
        h = h + mlp_forward(engine, lp["mlp"],
                            norm_apply(cfg.norm, lp["norm2"], h,
                                       cfg.norm_eps), cfg.act)
    h = norm_apply(cfg.norm, params["final_norm"], h, cfg.norm_eps)
    return h, caches
