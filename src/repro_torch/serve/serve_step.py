"""Serving steps (PyTorch port of ``repro/serve/serve_step.py``): prefill
(build the caches and the first logits), one-token decode against the slot
engine's cache buffers, and the block-table step of the paged scheduler.

Each `make_*` returns a plain function over parameter and cache dicts; the
engines call it under ``torch.inference_mode()``.  Every projection, the
LM head and attention dispatch the engine, so on the `cuda` backend the
path runs the port's GEMM, flash-attention and split-KV decode kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ComputeEngine
from repro_torch.models import transformer as tfm
from repro_torch.models.common import lm_head_logits
from repro_torch.serve import kvpool


def make_prefill_step(engine: ComputeEngine, cfg):
    """prefill_step(params, tokens (B, S)) -> (last-position logits
    (B, 1, V_padded) fp32, caches [{"k", "v": (n_layers, B, S, KV, hd)}])."""
    def prefill_step(params, tokens):
        h, caches = tfm.forward_prefill(engine, cfg, params, tokens=tokens)
        logits = lm_head_logits(engine, h[:, -1:, :],
                                tfm.head_weight(params, cfg),
                                vocab_real=cfg.vocab_size)
        return logits, caches
    return prefill_step


def make_decode_step(engine: ComputeEngine, cfg):
    """decode_step(params, caches, token (B, C), pos) -> (logits
    (B, C, V_padded) fp32, caches written in place).  On `cuda` a
    decode-shaped dispatch (C <= 8 against a cache buffer of 256 rows or
    more) takes the split-KV decode kernel."""
    def decode_step(params, caches, token, pos):
        h, caches = tfm.decode_hidden(engine, cfg, params, caches, token, pos)
        logits = lm_head_logits(engine, h, tfm.head_weight(params, cfg),
                                vocab_real=cfg.vocab_size)
        return logits, caches
    return decode_step


def make_paged_step(engine: ComputeEngine, cfg):
    """The block-table step over a paged KV pool (serve/kvpool.py).

    paged_step(params, pools, block_tables (B, NB), tokens (B, C),
    pos (B,)) -> (logits (B, C, V_padded) fp32, pools).  The three index
    arguments are host numpy int arrays: they are checked on the host
    (block ids within the pool, 0 <= pos and pos + C <= NB * block_size,
    so no write leaves a sequence's table) and then moved to the device.
    The step gathers the batch's blocks into the compact cache layout,
    runs C tokens through `decode_hidden` with per-sequence start
    positions (the attention op masks each sequence at its own kv_len),
    and scatters only the newly written rows back into the pools, in
    place.  One function serves both traffic shapes: chunked prefill
    (B = 1, C = chunk) and batched decode (B = bucket, C = 1).
    """
    def paged_step(params, pools, block_tables, tokens, pos):
        n_blocks = pools[0]["k"].shape[1]           # including the trash
        bs = pools[0]["k"].shape[2]
        b, nb = block_tables.shape
        c = tokens.shape[1]
        if tokens.shape[0] != b or pos.shape != (b,):
            raise ValueError(f"tables {block_tables.shape}, tokens "
                             f"{tokens.shape} and pos {pos.shape} disagree")
        if block_tables.min() < 0 or block_tables.max() >= n_blocks:
            raise ValueError(f"block ids must lie in [0, {n_blocks})")
        if pos.min() < 0 or pos.max() + c > nb * bs:
            raise ValueError(f"rows [pos, pos + {c}) must lie within the "
                             f"{nb * bs} rows of the tables; pos {pos}")
        dev = pools[0]["k"].device
        tables = torch.from_numpy(np.ascontiguousarray(block_tables,
                                                       np.int64)).to(dev)
        start = torch.from_numpy(np.asarray(pos, np.int64)).to(dev)
        toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
        caches = kvpool.gather_block_cache(pools, tables)
        h, caches = tfm.decode_hidden(engine, cfg, params, caches, toks,
                                      start)
        logits = lm_head_logits(engine, h, tfm.head_weight(params, cfg),
                                vocab_real=cfg.vocab_size)
        kvpool.scatter_chunk(pools, caches, tables, start, c)
        return logits, pools
    return paged_step


def greedy_sample(logits) -> torch.Tensor:
    """Greedy next tokens (B,) int32 from logits (B, C, V): argmax of the
    last position, on the logits' device."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
