"""MLP blocks on the compute engine (PyTorch port of ``repro/models/mlp.py``).

SwiGLU (silu act) or a plain GELU MLP: every projection is one fused GEMM
on the engine, and the gate's silu runs in that GEMM's epilogue.
"""
from __future__ import annotations

import torch

from repro_torch.core import ComputeEngine


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             device=None) -> dict:
    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device) / fan_in ** 0.5

    p = {"wu": normal((d_model, d_ff), d_model),
         "wd": normal((d_ff, d_model), d_ff)}
    if act == "silu":  # gated (SwiGLU)
        p["wg"] = normal((d_model, d_ff), d_model)
    return p


def mlp_forward(engine: ComputeEngine, p: dict, x, act: str):
    if "wg" in p:
        # SwiGLU: silu(x @ wg) * (x @ wu); the silu is fused into the gate
        # GEMM's epilogue.
        h = engine.matmul(x, p["wg"], act="silu") * engine.matmul(x, p["wu"])
    else:
        h = engine.matmul(x, p["wu"], act=act)
    return engine.matmul(h, p["wd"])
