"""Optimizers on dicts of named tensors (PyTorch port of
``repro/train/optimizer.py``).

AdamW with decoupled weight decay and global-norm clipping, and SGD with
momentum as the cheap baseline.  Parameters, gradients and moments are
dicts keyed by parameter name (``dict(net.named_parameters())``); moments
are fp32.  The JAX functions return new trees; these update the parameter
and moment tensors IN PLACE under ``torch.no_grad()`` (so an ``nn.Module``
keeps its own ``Parameter`` objects) and return the same dicts.

Kept from the JAX package: the step counter goes up before `schedule` is
read, and weight decay applies to every leaf, batch-norm vectors and
biases included.  ``torch.optim.AdamW`` is not used: it decays the weights
in another order and has no such schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device: no host synchronisation)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(tree scaled by min(1, max_norm / norm), norm): new tensors."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, gn


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"mu": {...}, "nu": {...}, "step": 0}``, fp32 zero moments."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return {"mu": zeros, "nu": {k: z.clone() for k, z in zeros.items()},
            "step": 0}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: dict, params: Mapping[str, torch.Tensor]):
    """One AdamW step, in place: returns ``(params, state, lr)`` with the
    same parameter and moment tensors updated and ``state["step"]`` up by
    one (read by `schedule` after the increment, as the JAX step)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    for k, p in params.items():
        g = grads[k].float()
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.float()
        delta = ((mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
                 + cfg.weight_decay * pf)
        p.copy_(pf - lr * delta)
    state["step"] = step
    return params, state, lr


def sgdm_init(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"mom": {...}, "step": 0}``, fp32 zero momentum."""
    return {"mom": {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}, "step": 0}


@torch.no_grad()
def sgdm_update(grads: Mapping[str, torch.Tensor], state: dict,
                params: Mapping[str, torch.Tensor], lr: float = 1e-2,
                beta: float = 0.9):
    """mom = beta * mom + g; p -= lr * mom, in place.  Returns
    ``(params, state)``."""
    for k, p in params.items():
        mom = state["mom"][k]
        mom.mul_(beta).add_(grads[k].float())
        p.copy_(p.float() - lr * mom)
    state["step"] += 1
    return params, state
