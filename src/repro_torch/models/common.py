"""Shared model pieces: norms, RoPE, embeddings, the LM head and the
chunked cross-entropy of the training loss (PyTorch port of
``repro/models/common.py``)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import ComputeEngine


# ------------------------------------------------------------------ norms ---
# PyTorch's row-reduction kernel picks its launch shape, and with it the
# order in which a row is summed, from the number of rows.  A norm over a
# decode batch would then give a sequence other bits in a batch of 8 than
# alone.  `row_mean` pads the rows to a multiple of ROW_PAD (zero rows, cut
# off again), so every decode bucket (1 to 8 rows) reduces the same (8, D)
# shape and a sequence's logits are bitwise the same in every bucket.
ROW_PAD = 8


def row_mean(x):
    """Mean over the last dim, keepdim, with the rows padded (see above)."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    n = rows.shape[0]
    if n % ROW_PAD:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, -n % ROW_PAD))
    return rows.mean(dim=-1, keepdim=True)[:n].reshape(*x.shape[:-1], 1)


def rmsnorm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = row_mean(x32 * x32)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = row_mean(x32)
    xc = x32 - mu
    y = xc * torch.rsqrt(row_mean(xc * xc) + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_apply(kind: str, p: dict, x, eps: float):
    if kind == "rms":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


def norm_init(kind: str, d: int, device=None) -> dict:
    p = {"scale": torch.ones(d, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros(d, device=device)
    return p


# ------------------------------------------------------------------- RoPE ---

def rope_table(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int -> cos, sin tables (..., dim/2) fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin):
    """x (..., S, H, D); cos / sin (S, D/2), or (B, S, D/2) for
    per-sequence positions (broadcast over the heads)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    c, s = cos[..., None, :].float(), sin[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------- embeddings ---

def embed_init(generator: torch.Generator, vocab_padded: int, d: int,
               device=None) -> dict:
    return {"tokens": torch.randn(vocab_padded, d, generator=generator,
                                  device=device) * 0.02}


def embed_lookup(p: dict, tokens, compute_dtype):
    """Rows of the embedding table for `tokens`, cast to the compute dtype
    after the gather (the same values as casting the table first).  The
    gather is `F.embedding`, whose gradient (a scatter-add over repeated
    tokens) PyTorch sums in a fixed order on the card, so a train step's
    bits are the same run to run."""
    return torch.nn.functional.embedding(tokens, p["tokens"]).to(
        compute_dtype)


# ---------------------------------------------------------------- LM head ---

def lm_head_logits(engine: ComputeEngine, h, w_head, *, vocab_real: int):
    """fp32 logits h @ w_head on the engine's GEMM; padded vocab columns
    are set to -1e30."""
    logits = engine.matmul(h, w_head, out_dtype=torch.float32)
    logits[..., vocab_real:] = -1e30
    return logits


# -------------------------------------------------- chunked cross-entropy ---

def _chunk_ce(engine: ComputeEngine, hx, w_head, lx, vocab_real: int):
    """Sum over one (B, chunk) slice of logsumexp(logits) - gold logit."""
    logits = engine.matmul(hx, w_head, out_dtype=torch.float32)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_real
    logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)                    # (B, chunk)
    gold = torch.gather(logits, -1, lx.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_cross_entropy(engine: ComputeEngine, h, w_head, labels, *,
                          vocab_real: int, chunk: int = 512):
    """Mean token cross-entropy over (B, S), in fp32.

    h (B, S, D); w_head (D, V_padded), e.g. a tied head's ``embed.t()``,
    read in place; labels (B, S) int.  Runs over sequence chunks of
    `chunk` (S must be a multiple of it): the head logits of a chunk in
    fp32 from the engine's GEMM, the padded vocab masked to -1e30, then
    logsumexp minus the gold logit.  Each chunk runs under
    ``torch.utils.checkpoint`` (its logits are recomputed in the backward),
    so one (B, chunk, V) logits tensor is alive at a time: 2.49 GB at
    B 8 x 512 x 151936.  The JAX version scans the chunks under jit.
    """
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the CE chunk "
                         f"{chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_ce, engine, h[:, c0:c0 + chunk], w_head,
            labels[:, c0:c0 + chunk], vocab_real, use_reentrant=False,
            preserve_rng_state=False)
    return total / (b * s)
