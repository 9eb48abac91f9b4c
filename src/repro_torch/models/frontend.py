"""Modality frontends (PyTorch port of ``repro/models/frontend.py``).

The ``vlm`` and ``audio`` configs specify the transformer backbone; their
inputs carry precomputed patch or frame embeddings (`configs.base.
input_tensors`).  What the model owns is the projector that maps those
features into d_model:

  vision : LayerNorm + 2-layer MLP projector (InternVL's mlp1) over the
           patch embeddings; the visual tokens are prepended to the text
           embeddings (`models.transformer`).
  audio  : feature projection (LayerNorm + Linear), wav2vec2 / HuBERT style.

Each projection is one `engine.matmul` with its bias as the shift (and the
first vision layer's gelu in the epilogue), so on `cuda` it is the fused
GEMM kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ComputeEngine
from repro_torch.models.common import layernorm


def frontend_init(generator: torch.Generator, cfg, device=None) -> dict:
    """The projector's parameters with the JAX package's initialisation
    rules (its numbers differ: this draws from `generator`); {} without a
    frontend."""
    if cfg.frontend == "none":
        return {}
    fd, d = cfg.frontend_dim, cfg.d_model

    def normal(rows, cols):
        return torch.randn(rows, cols, generator=generator,
                           device=device) / rows ** 0.5

    ln = {"scale": torch.ones(fd, device=device),
          "bias": torch.zeros(fd, device=device)}
    if cfg.frontend == "vision":
        return {"ln": ln, "w1": normal(fd, d),
                "b1": torch.zeros(d, device=device), "w2": normal(d, d),
                "b2": torch.zeros(d, device=device)}
    return {"ln": ln, "w": normal(fd, d), "b": torch.zeros(d, device=device)}


def frontend_apply(engine: ComputeEngine, p: dict, feats, cfg):
    """feats (B, T, frontend_dim) -> (B, T, d_model)."""
    x = layernorm(feats, p["ln"]["scale"], p["ln"]["bias"], cfg.norm_eps)
    if cfg.frontend == "vision":
        h = engine.matmul(x, p["w1"], shift=p["b1"], act="gelu")
        return engine.matmul(h, p["w2"], shift=p["b2"])
    return engine.matmul(x, p["w"], shift=p["b"])
