"""`chip_smoke.py`'s route recorder by layer, under remat, on the CPU.

The MoE training phases on the card compare `cuda`'s step with `eager`'s
and `ref`'s while both run `cuda`'s expert choices (`RouteReplay`), so a
near tie that flips a route cannot part the programs.  Under remat
(`loss_fn(remat=True)`, as `lm_grads` and the train step run it) every
MoE layer routes twice a step: in the forward, and again when
`torch.utils.checkpoint` recomputes it in the backward, in reverse layer
order.  The recorder keys each routing by the layer's router tensor, so
here, on reduced deepseek-v2-lite-16b (a `mla_dense` and two `mla_moe`
layers) and reduced llama4-scout on `eager`: the log holds one route a
layer and counts each recompute; replaying the engine's own routes leaves
the loss and every gradient bit for bit those of no replay; a replay of
other routes reaches the forward and the recompute of each layer alike,
so its gradients are those of the same replay without remat.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import make_engine
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.tree import flatten, unflatten_like

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] /
    "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

ENGINE = make_engine("eager", device="cpu")
ARCHS = {"deepseek": ("deepseek-v2-lite-16b", 3),
         "llama4": ("llama4-scout-17b-a16e", 2)}


def _model(name):
    arch, layers = ARCHS[name]
    cfg = dataclasses.replace(reduced(get_arch(arch)), n_layers=layers)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
             for k in ("tokens", "labels")}
    return cfg, params, batch


def _grads(cfg, params, batch, remat):
    leaves = {k: p.detach().requires_grad_()
              for k, p in flatten(params).items()}
    loss = tfm.loss_fn(ENGINE, cfg, unflatten_like(leaves, params), batch,
                       remat=remat, ce_chunk=16)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves.values(), grads)]


@pytest.mark.parametrize("name", list(ARCHS))
def test_own_routes_replayed_by_layer_keep_the_bits(name):
    cfg, params, batch = _model(name)
    n_moe = cs.n_moe_layers(cfg)
    with cs.RouteLog(by_layer=True) as log:
        loss, grads = _grads(cfg, params, batch, remat=True)
    assert len(log.calls) == n_moe >= 2
    assert log.recomputed == n_moe
    with cs.RouteReplay(log.calls, by_layer=True) as rp:
        loss2, grads2 = _grads(cfg, params, batch, remat=True)
    assert rp.recomputed == n_moe and len(rp.calls) == n_moe
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(log.calls, rp.calls))


@pytest.mark.parametrize("name", list(ARCHS))
def test_replayed_routes_reach_the_forward_and_its_recompute(name):
    cfg, params, batch = _model(name)
    n_moe = cs.n_moe_layers(cfg)
    with cs.RouteLog(by_layer=True) as log:
        own, _ = _grads(cfg, params, batch, remat=True)
    forced = [((idx + 1) % cfg.n_routed_experts, probs)
              for idx, probs in log.calls]
    runs = {}
    for remat in (True, False):
        seen = []
        with cs.RouteReplay(forced, by_layer=True):
            inner = moe.route

            def spy(engine, p, x, c, inner=inner):
                w, idx, probs = inner(engine, p, x, c)
                seen.append(idx)
                return w, idx, probs

            moe.route = spy
            try:
                runs[remat] = _grads(cfg, params, batch, remat=remat)
            finally:
                moe.route = inner
        order = list(range(n_moe))
        if remat:  # the forward, then the recompute in reverse layer order
            order += order[::-1]
        assert len(seen) == len(order)
        for idx, layer in zip(seen, order):
            assert torch.equal(idx, forced[layer][0])
    assert not torch.equal(runs[True][0], own)
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
