"""The port's LM serving engines against the JAX package, on the CPU.

The ragged stream of ``tests/test_paged_serving.py`` (reduced qwen2-0.5b,
prompts of 2-11 tokens, 2-6 new tokens each) goes through the JAX slot
and paged engines on `xla` and through the port's on `eager`, with the JAX
parameters carried across.  The greedy token streams must be equal.  The
setup asserts that the JAX top-2 logit margin exceeds 1e-3 at every
emitted token, so a near-tie that two correct fp32 programs could break
either way cannot decide the result.  Also: admission, rejection, deadline
expiry, the build bound, the allocator, gather / scatter and the step
cache, each against the JAX package where it has a counterpart.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.models import transformer as jax_tfm
from repro.models.common import lm_head_logits as jax_lm_head_logits
from repro.serve import kvpool as jax_kvpool
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.serve.scheduler import PagedServingEngine as JaxPagedEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import StepCompileCache, make_engine
from repro_torch.serve import frontend as fe
from repro_torch.serve import kvpool
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine
from repro_torch.serve.serve_step import make_paged_step

torch.set_num_threads(1)

ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
MARGIN = 1e-3
PAGED = dict(kv_blocks=8, block_size=8, max_len=32, chunk=4,
             batch_buckets=(1, 2, 4))


def _stream(cls, cfg, n, seed=0, prompt_hi=12, new_hi=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(2, prompt_hi))
                                           ).tolist(),
                max_new=int(rng.integers(2, new_hi)))
            for i in range(n)]


def _margins(jcfg, jparams, reqs) -> list[float]:
    """Teacher-forced JAX top-2 margin at every emitted token."""
    out = []
    w = jax_tfm.head_weight(jparams, jcfg)
    for r in reqs:
        seq = r.prompt + r.out[:-1]
        h, _ = jax_tfm.forward_hidden(JAX_ENGINE, jcfg, jparams,
                                      tokens=jnp.asarray([seq], jnp.int32))
        logits = np.asarray(jax_lm_head_logits(
            JAX_ENGINE, h, w, vocab_real=jcfg.vocab_size))[0]
        rows = logits[len(r.prompt) - 1:]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        assert [int(t) for t in rows.argmax(-1)] == r.out
        out.extend((top2[:, 1] - top2[:, 0]).tolist())
    return out


@pytest.fixture(scope="module")
def served():
    jcfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    cfg = base.reduced(base.get_arch("qwen2-0.5b"))
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jslot = _stream(JaxRequest, jcfg, 6)
    JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=2,
                     max_len=32).run(jslot)
    jpaged = _stream(JaxRequest, jcfg, 6)
    JaxPagedEngine(jcfg, jparams, engine=JAX_ENGINE, **PAGED).run(jpaged)
    margins = _margins(jcfg, jparams, jpaged)
    assert min(margins) > MARGIN, min(margins)
    return cfg, params, [r.out for r in jslot], [r.out for r in jpaged]


def _paged(cfg, params, **kw):
    return PagedServingEngine(cfg, params, engine=ENGINE, **{**PAGED, **kw})


def test_jax_slot_and_paged_streams_agree(served):
    _, _, jslot, jpaged = served
    assert jslot == jpaged


def test_paged_engine_streams_equal_the_jax_engines(served):
    cfg, params, _, jpaged = served
    reqs = _stream(Request, cfg, 6)
    paged = _paged(cfg, params)
    paged.run(reqs)
    assert [r.out for r in reqs] == jpaged
    st = paged.stats()
    assert st["requests"]["completed"] == 6
    assert st["requests"]["rejected"] == 0
    assert st["pool"]["used_blocks"] == 0           # all blocks recycled
    assert st["pool"]["peak_used"] > 0
    assert set(fe.STATS_KEYS) <= set(st)
    assert set(fe.LATENCY_KEYS) == set(st["latency_s"])


def test_slot_engine_streams_equal_the_jax_engines(served):
    cfg, params, jslot, _ = served
    reqs = _stream(Request, cfg, 6)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32)
    slot.run(reqs)
    assert [r.out for r in reqs] == jslot
    st = slot.stats()
    assert st["requests"]["completed"] == 6 and st["tokens"] == sum(
        len(o) for o in jslot)
    assert st["op_counts"] == {("eager", "matmul"): 7 * cfg.n_layers + 1,
                               ("eager", "attention"): cfg.n_layers}


def test_builds_stay_within_the_bucket_bound(served):
    cfg, params, _, _ = served
    paged = _paged(cfg, params)
    paged.run(_stream(Request, cfg, 6))
    st = paged.stats()
    assert 0 < st["compile"]["traces"] <= st["trace_bound"]
    assert st["compile"]["calls"] == sum(st["compile"]["dispatches"].values())
    for bb, cc, nb in st["compile"]["dispatches"]:
        assert (bb, cc) in {(1, paged.chunk)} | {
            (x, 1) for x in paged.batch_buckets}
        assert nb in paged.block_buckets


def test_inadmissible_requests_rejected_at_submit(served):
    cfg, params, _, _ = served
    paged = _paged(cfg, params)
    with pytest.raises(fe.RejectedRequest, match="empty prompt"):
        paged.submit(Request(rid=0, prompt=[], max_new=2))
    with pytest.raises(fe.RejectedRequest, match="exceeds max_len"):
        paged.submit(Request(rid=1, prompt=[1] * 33, max_new=2))
    with pytest.raises(kvpool.PoolExhausted, match="worst-case"):
        paged.submit(Request(rid=2, prompt=[1] * 8, max_new=64))
    assert paged.stats()["requests"]["rejected"] == 3
    assert not paged.pending
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=1, max_len=8)
    with pytest.raises(fe.RejectedRequest, match="exceeds the KV cache"):
        slot.submit(Request(rid=3, prompt=[1] * 9, max_new=2))


def test_slot_engine_refuses_an_empty_prompt(served):
    """An empty prompt would decode the slot's previous occupant's last
    token (the JAX slot engine does, ROADMAP); the port refuses it at
    submit, as the paged engine does, counts it rejected, and the streams
    served around the refusal stay the JAX engine's."""
    cfg, params, jslot, _ = served
    reqs = _stream(Request, cfg, 6)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32)
    slot.run(reqs[:3])
    with pytest.raises(fe.RejectedRequest, match="empty prompt"):
        slot.submit(Request(rid=9, prompt=[], max_new=4))
    assert not slot.pending
    slot.run(reqs[3:])
    assert [r.out for r in reqs] == jslot
    st = slot.stats()
    assert (st["requests"]["rejected"], st["requests"]["completed"]) == (1, 6)


def test_deadline_expires_blocked_requests(served):
    cfg, params, _, _ = served
    paged = _paged(cfg, params, kv_blocks=4, max_wait_s=0.0)
    hog = Request(rid=0, prompt=[1, 2, 3], max_new=30)   # reserves the pool
    late = Request(rid=1, prompt=[4, 5, 6], max_new=30)
    paged.submit(hog)
    paged.step()
    paged.submit(late)
    time.sleep(0.01)
    while paged.active:
        paged.step()
    st = paged.stats()
    assert hog.done and not late.done
    assert (st["expired"], st["requests"]["rejected"],
            st["requests"]["completed"]) == (1, 1, 1)


def test_admission_reserves_worst_case(served):
    cfg, params, _, _ = served
    paged = _paged(cfg, params, kv_blocks=4)
    reqs = _stream(Request, cfg, 5, seed=3, prompt_hi=10, new_hi=6)
    paged.run(reqs)
    assert all(r.done for r in reqs)
    st = paged.stats()
    assert st["pool"]["peak_used"] <= 4
    assert paged.step() == 0                  # idle: counted, no dispatch
    assert paged.stats()["idle_steps"] == st["idle_steps"] + 1
    assert paged.stats()["steps"] == st["steps"]


def _apply(alloc, op, sid, n):
    """One allocator operation; its result, or the name of what it
    raised."""
    try:
        if op == "alloc":
            return alloc.alloc(sid, n)
        if op == "extend":
            return alloc.extend(sid, n)
        return alloc.free(sid)
    except (KeyError, ValueError) as e:     # PoolExhausted is a ValueError
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_the_jax_allocator_under_churn(seed):
    """The same random alloc / extend / free script gives the same tables,
    stats and refusals in both allocators."""
    rng = np.random.default_rng(seed)
    mine = kvpool.BlockAllocator(12, 4)
    theirs = jax_kvpool.BlockAllocator(12, 4)
    for _ in range(300):
        op = ("alloc", "extend", "free")[int(rng.integers(3))]
        sid, n = int(rng.integers(8)), int(rng.integers(0, 24))
        assert _apply(mine, op, sid, n) == _apply(theirs, op, sid, n)
        assert mine.stats() == theirs.stats()
        assert all(mine.table(s) == theirs.table(s)
                   for s in range(8) if mine.holds(s))
    with pytest.raises(KeyError, match="double free"):
        mine.free(-1)


def test_gather_and_scatter_match_the_jax_pool_functions():
    cfg = base.reduced(base.get_arch("qwen2-0.5b"))
    rng = np.random.default_rng(5)
    shape = (2, 7, 8, 2, 32)                 # 6 blocks + trash, 8 rows each
    pools = [{k: rng.standard_normal(shape).astype(np.float32)
              for k in ("k", "v")}]
    tables = np.array([[3, 1, 6], [0, 2, 6]], np.int32)
    pos = np.array([9, 2], np.int32)
    mine = kvpool.gather_block_cache(
        [{k: torch.from_numpy(v) for k, v in pools[0].items()}],
        torch.from_numpy(tables).long())
    theirs = jax_kvpool.gather_block_cache(
        [{k: jnp.asarray(v) for k, v in pools[0].items()}],
        jnp.asarray(tables))
    for k in ("k", "v"):
        assert np.array_equal(mine[0][k].numpy(), np.asarray(theirs[0][k]))
        mine[0][k][:, :, 9:13] += 1.0         # rows a 4-token chunk wrote
    jcaches = [{k: jnp.asarray(mine[0][k].numpy()) for k in ("k", "v")}]
    want = jax_kvpool.scatter_chunk(
        [{k: jnp.asarray(v) for k, v in pools[0].items()}], jcaches,
        jnp.asarray(tables), jnp.asarray(pos), 4)
    got = kvpool.scatter_chunk(
        [{k: torch.from_numpy(v.copy()) for k, v in pools[0].items()}],
        mine, torch.from_numpy(tables).long(), torch.from_numpy(pos), 4)
    trash = kvpool.PagedKVCache(cfg, 6, 8).trash_block
    for k in ("k", "v"):
        a, b = got[0][k].numpy(), np.asarray(want[0][k])
        assert np.array_equal(np.delete(a, trash, 1), np.delete(b, trash, 1))


def test_paged_step_refuses_rows_outside_the_tables():
    cfg = base.reduced(base.get_arch("qwen2-0.5b"))
    cache = kvpool.PagedKVCache(cfg, 4, 8)
    step = make_paged_step(ENGINE, cfg)
    tables = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match="within the 16 rows"):
        step({}, cache.pools, tables, np.zeros((1, 4), np.int32),
             np.array([13], np.int32))
    with pytest.raises(ValueError, match="block ids"):
        step({}, cache.pools, tables + 5, np.zeros((1, 1), np.int32),
             np.array([0], np.int32))


def test_step_cache_counts_builds_not_calls():
    cache = StepCompileCache(lambda x: x * 2, name="double")
    a2, a4 = torch.ones(2), torch.ones(4)
    assert torch.equal(cache(a2), 2 * torch.ones(2))
    cache(a2)
    cache(a2)
    assert (cache.traces, cache.calls) == (1, 3)
    cache(a4)
    cache(np.ones(4))                 # a numpy float64 array: another key
    assert (cache.traces, cache.calls) == (3, 5)
    cache.record((2,))
    cache.record((2,))
    cache.record((4,))
    st = cache.stats()
    assert st["name"] == "double" and st["dispatches"] == {(2,): 2, (4,): 1}
