"""Mixture-of-Experts: top-k router, grouped capacity dispatch and a gated
expert MLP on the engine (PyTorch port of ``repro/models/moe.py``).

Dispatch follows the GShard / Switch grouped formulation, as in JAX: each
batch row is a routing group, its tokens scatter into a (B, E, C, D)
dispatch tensor, the experts run as three batched GEMMs over the E experts
(`ComputeEngine.einsum`; on `cuda` the hand-written bmm kernel), and the
results gather back weighted by the router.  Capacity overflow drops
tokens (their routed weight is zeroed; they pass through the residual
connection).  The shared expert (Llama4) is a dense SwiGLU MLP of width
``n_shared_experts * moe_d_ff``, always on.

The JAX layer also places sharding hints (``hints.shard``) and, under
``moe_dispatch="local"``, keeps the scatter model-replicated; both only
steer the partitioner across a mesh.  On one device they are no-ops, so
the port leaves them out and ``moe_dispatch`` changes nothing here.
"""
from __future__ import annotations

import torch

from repro_torch.core import ComputeEngine
from repro_torch.models.mlp import mlp_forward, mlp_init


def moe_init(generator: torch.Generator, cfg, device=None) -> dict:
    """Router (D, E), expert weights wg / wu (E, D, F) and wd (E, F, D),
    and the shared expert's MLP dict when the config has one; the JAX
    package's initialisation rules (its numbers differ)."""
    d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device).div_(fan_in ** 0.5)

    p = {"router": normal((d, e), d), "wg": normal((e, d, f), d),
         "wu": normal((e, d, f), d), "wd": normal((e, f, d), f)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, d, cfg.n_shared_experts * f,
                               "silu", device)
    return p


def capacity(tokens_per_group: int, cfg) -> int:
    """Rows per expert and group: the group's share of top_k tokens times
    the capacity factor, rounded up to a multiple of 8, at least 8."""
    c = int(tokens_per_group * cfg.top_k / cfg.n_routed_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(engine: ComputeEngine, p: dict, x, cfg):
    """The router of `moe_forward`: (weights (B, S, K) fp32, renormalised
    over the top k, expert ids (B, S, K), probabilities (B, S, E) fp32)."""
    scores = engine.matmul(x, p["router"], out_dtype=torch.float32)
    probs = torch.softmax(scores, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def positions(idx, n_experts: int):
    """Each (token, choice)'s row in its expert within its group (B, S, K):
    its rank among the group's choices of that expert in (token, choice)
    order, from a stable argsort of the expert ids, as the JAX layer ranks
    them (O(S K) memory, no (S K, E) one-hot)."""
    b, s, k = idx.shape
    ids = idx.reshape(b, s * k)
    order = torch.argsort(ids, dim=1, stable=True)
    ar = torch.arange(s * k, device=idx.device).expand(b, -1)
    inv = torch.empty_like(order).scatter_(1, order, ar)
    counts = torch.zeros((b, n_experts), dtype=torch.int64,
                         device=idx.device).scatter_add_(
        1, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, dim=1) - counts
    return (inv - torch.gather(starts, 1, ids)).reshape(b, s, k)


def moe_forward(engine: ComputeEngine, p: dict, x, cfg):
    """x (B, S, D) -> (y (B, S, D), aux loss, a 0-d fp32 tensor).

    The routing and the aux loss run in fp32.  Each routing group is a
    batch row, so a decode step's group is a row's new tokens.  Under the
    mixed policy the expert GEMMs accumulate in fp32 and round to the
    policy's reduce dtype, as JAX's ``acc_dtype = reduce_dtype``."""
    b, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.top_k
    c = capacity(s, cfg)
    prec = engine.precision
    cdt, rdt = prec.compute_dtype, prec.reduce_dtype

    w, idx, probs = route(engine, p, x, cfg)
    # Switch load-balance loss: E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    fe = torch.nn.functional.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(fe * me)

    pos = positions(idx, e)
    keep = pos < c
    w = w * keep.to(w.dtype)

    # Scatter into (B, E, C + 1, D) without accumulating: kept tokens hold
    # distinct rows, so the kept rows are deterministic on the card; the
    # dropped ones land in scratch row C (JAX's), which is cut off.
    b_idx = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    disp = torch.zeros((b, e, c + 1, d), dtype=cdt, device=x.device)
    disp[b_idx, idx, torch.where(keep, pos, c)] = (
        x.to(cdt)[:, :, None, :].expand(b, s, k, d))
    disp = disp[:, :, :c]

    # the gated expert MLP: three batched GEMMs over the experts
    g = engine.einsum("becd,edf->becf", disp, p["wg"], acc_dtype=rdt,
                      out_dtype=rdt)
    u = engine.einsum("becd,edf->becf", disp, p["wu"], acc_dtype=rdt,
                      out_dtype=rdt)
    h = (g * torch.sigmoid(g.float()).to(rdt) * u).to(cdt)
    eo = engine.einsum("becf,efd->becd", h, p["wd"], acc_dtype=rdt,
                       out_dtype=rdt).to(cdt)

    # gather each token's K expert outputs, weighted, in the compute dtype
    got = eo[b_idx, idx, torch.where(keep, pos, 0)]            # (B, S, K, D)
    y = torch.sum(got * w.to(got.dtype)[..., None], dim=2).to(x.dtype)
    if "shared" in p:
        y = y + mlp_forward(engine, p["shared"], x, "silu")
    return y, aux
