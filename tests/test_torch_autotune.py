"""The port's measured autotuner (`repro_torch/core/autotune.py` and the
registry's plan cache) on the CPU: the counterpart of test_autotune.py.

* Persistence: the record format, zero re-timing after a simulated fresh
  process with a poisoned timer, corrupt / stale / wrong-device table
  files, an unwritable directory, merging writers.
* Policies: off, heuristic never touching disk, unknown policies, the
  loud warning on a bad REPRO_AUTOTUNE, the scoped context manager.
* `Network.compile(autotune=...)` and `compile_cache(autotune=...)` on the
  JAX test's two-layer config.
* Against the JAX package: equal key strings, a JAX-written table read
  entry for entry, fingerprints that differ, the same conv2d keys as the
  JAX `pallas` compile.
* Port only: the heuristic pick is today's rule, candidates are
  instantiated plans with the heuristic first, the dW split and the decode
  split never move with the policy, an illegal persisted pick warns and
  resolves to the heuristic, measuring inside a capture raises.

A test-local backend (`tuned`) runs the `eager` ops with the `cuda`
backend's picker and candidates and a stub bench whose "time" is a
function of the plan, so the measure policy resolves deterministically
without a card.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import autotune as jax_autotune
from repro.core import backends as jax_backends
from repro.core import make_engine as jax_make_engine
from repro.core.darknet.network import Network as JaxNetwork
from repro_torch.core import autotune, backends, make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm, ops

torch.set_num_threads(1)

# The JAX test's TWO_CONV_CFG (tests/test_autotune.py).
TWO_CONV_CFG = """
[net]
height=16
width=16
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=4
size=3
stride=2
pad=1
activation=leaky
"""

CUDA = backends.get_backend("cuda")
TIME_THUNK = autotune.time_thunk  # before the fixture stubs it


def _fake_ms(tiles) -> float:
    """The stub bench's time of a plan: the later a plan stands in its
    kernel's plan list, the faster, so a measured pick differs from the
    heuristic one wherever the heuristic is not the last plan."""
    for plans in (gemm.PLANS, gemm.BWD_PLANS, fa.PLANS, fa.BWD_PLANS):
        if tuple(tiles) in plans:
            return 10.0 - plans.index(tuple(tiles))
    raise AssertionError(f"benched a plan no kernel has: {tiles}")


def _stub_bench(op, shapes, dtype, tiles):
    return lambda: _fake_ms(tiles)


@pytest.fixture(autouse=True)
def isolated_autotune(tmp_path, monkeypatch):
    """Persistence in a scratch dir, all in-process state reset, timing by
    the stub's numbers, the `tuned` backend registered; the policy and the
    caches restored afterwards so other test modules are unaffected."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.setattr(autotune, "time_thunk", lambda thunk, **kw: thunk())
    backends.register_backend(
        "tuned", dict(backends.get_backend("eager").ops),
        tile_picker=CUDA.tile_picker, tile_candidates=CUDA.tile_candidates,
        tile_bench=_stub_bench, overwrite=True)
    backends.clear_tile_cache()
    autotune.reset()
    prev = backends.get_autotune_policy()
    yield tmp_path
    backends.set_autotune_policy(prev)
    backends.clear_tile_cache()
    autotune.reset()
    backends._REGISTRY.pop("tuned", None)


def _engine():
    return dataclasses.replace(make_engine("eager", device="cpu"),
                               backend="tuned")


def _matmul(m=48, k=40, n=24):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m, k)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (k, n)).astype(np.float32))
    return _engine().matmul(x, w)


def _attention(b=1, sq=64, skv=64, h=4, kv=2, d=64):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, skv, kv, d, generator=g)
    v = torch.randn(b, skv, kv, d, generator=g)
    return _engine().attention(q, k, v, causal=True)


def _bmm(b=3, m=5, k=7, n=6):
    g = torch.Generator().manual_seed(0)
    return _engine().bmm(torch.randn(b, m, k, generator=g),
                         torch.randn(b, k, n, generator=g))


def _gemm_bwd():
    return backends.get_backend("tuned").tiles(
        "gemm_bwd", ops.gemm_bwd_key("bdw", 40, 48, 24, 4), torch.float32)


def _attention_bwd():
    return backends.get_backend("tuned").tiles(
        "attention_bwd", ((1, 64, 4, 64), (1, 64, 2, 64)), torch.float32)


def _fresh_process():
    """A new process on the same device: in-memory caches gone, the
    persisted table still on disk."""
    backends.clear_tile_cache()
    autotune.reset()


def _poison(monkeypatch, what):
    def no_timing(*a, **kw):
        raise AssertionError(f"re-timed a persisted {what} pick")
    monkeypatch.setattr(autotune, "time_thunk", no_timing)


# ------------------------------------------------------------ measuring ---

def test_measured_pick_recorded_and_persisted(tmp_path):
    backends.set_autotune_policy("measure")
    _matmul()
    st = backends.cache_stats()
    assert st["measured"] == 1 and st["persisted"] == 0
    (key, rec), = backends.autotune_report().items()
    assert key == '["matmul",[48,40,24],"float32","tuned"]'
    assert rec["source"] == "measured"
    assert tuple(rec["pick"]) in {tuple(c) for c, _ in
                                  rec["candidates_timed"]}
    assert rec["est_ms"] == min(ms for _, ms in rec["candidates_timed"])
    assert [tuple(c) for c, _ in rec["candidates_timed"]] == \
        ops.candidate_blocks("matmul", 48, 40, 24, "float32")
    assert tuple(rec["pick"]) == gemm.PLANS[-1] != ops.default_tiles(
        48, 40, 24)
    path = autotune.table_path()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        table = json.load(f)
    assert table["version"] == autotune.TABLE_VERSION
    assert table["fingerprint"] == autotune.device_fingerprint()
    assert table["entries"][key]["pick"] == rec["pick"]


@pytest.mark.parametrize("run,prefix", [
    (_matmul, '["matmul"'), (_bmm, '["bmm"'), (_attention, '["attention"'),
    (_gemm_bwd, '["gemm_bwd",["bdw",4,'),
    (_attention_bwd, '["attention_bwd"'),
])
def test_roundtrip_uses_persisted_pick_with_zero_retiming(monkeypatch, run,
                                                          prefix):
    backends.set_autotune_policy("measure")
    run()
    rep = backends.autotune_report()
    assert len(rep) == 1 and next(iter(rep)).startswith(prefix)
    _fresh_process()
    _poison(monkeypatch, prefix)
    run()
    st = backends.cache_stats()
    assert st["measured"] == 0 and st["persisted"] == 1
    for key, rec in rep.items():
        got = backends.autotune_report()[key]
        assert got["pick"] == rec["pick"] and got["source"] == "persisted"


def test_measured_pick_is_used_on_cache_hits():
    backends.set_autotune_policy("measure")
    _matmul()
    (_, rec), = backends.autotune_report().items()
    before = backends.cache_stats()
    backends.set_autotune_policy("heuristic")  # a memoized pick still serves
    _matmul()
    st = backends.cache_stats()
    assert st["hits"] == before["hits"] + 1
    assert st["measured"] == before["measured"]
    assert tuple(rec["pick"]) == backends._TILE_CACHE[
        ("matmul", (48, 40, 24), "float32", "tuned")]


def test_measured_pick_matches_heuristic_numerics():
    """Whatever plan measurement picks, the result is bitwise the
    heuristic's: a plan only changes the schedule."""
    backends.set_autotune_policy("heuristic")
    want = _matmul(100, 70, 50)
    backends.clear_tile_cache()
    backends.set_autotune_policy("measure")
    got = _matmul(100, 70, 50)
    assert backends.cache_stats()["measured"] == 1
    assert torch.equal(got, want)


# ---------------------------------------------- corruption / staleness ---

@pytest.mark.parametrize("content", [
    "{ not json",                                            # corrupted
    json.dumps({"version": 999, "fingerprint": "x",
                "entries": {}}),                             # stale schema
    json.dumps({"version": autotune.TABLE_VERSION,
                "fingerprint": "some-other-device__v1",
                "entries": {"k": {"pick": ["A", 8, 16]}}}),  # wrong device
    json.dumps({"version": autotune.TABLE_VERSION}),         # no entries
    json.dumps([1, 2, 3]),                                   # wrong type
])
def test_bad_table_file_falls_back_to_measurement(content):
    path = autotune.table_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    backends.set_autotune_policy("measure")
    _matmul()                                # must not crash
    st = backends.cache_stats()
    assert st["measured"] == 1 and st["persisted"] == 0
    with open(path) as f:                    # overwritten with a valid one
        table = json.load(f)
    assert table["version"] == autotune.TABLE_VERSION
    assert len(table["entries"]) == 1
    _fresh_process()
    _matmul()
    assert backends.cache_stats()["persisted"] == 1


def test_unwritable_cache_dir_is_not_fatal(tmp_path, monkeypatch):
    blocked = tmp_path / "not-a-dir"
    blocked.write_text("in the way")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(blocked))
    backends.set_autotune_policy("measure")
    y = _matmul()                            # measures, fails to persist
    assert y.shape == (48, 24)
    assert backends.cache_stats()["measured"] == 1
    (_, rec), = backends.autotune_report().items()
    assert rec["source"] == "measured"
    assert autotune.store("k", {"pick": ["A", 8, 16]}) is False


def test_store_merges_concurrent_writers():
    backends.set_autotune_policy("measure")
    _matmul()
    path = autotune.table_path()
    with open(path) as f:
        table = json.load(f)
    other = autotune.key_str("matmul", (7, 7, 7), "float32", "tuned")
    table["entries"][other] = {"pick": ["A", 8, 16], "est_ms": 1.0,
                               "candidates_timed": [], "source": "measured"}
    with open(path, "w") as f:
        json.dump(table, f)
    _matmul(m=96)                            # a new key: measure and store
    with open(path) as f:
        merged = json.load(f)
    assert other in merged["entries"] and len(merged["entries"]) == 3


# ---------------------------------------------------------- policy knobs ---

def test_policy_off_bypasses_cache():
    backends.set_autotune_policy("off")
    _matmul()
    _matmul()
    assert backends.cache_stats() == {"hits": 0, "misses": 0, "measured": 0,
                                      "persisted": 0, "entries": 0}


def test_heuristic_policy_never_touches_disk(monkeypatch):
    backends.set_autotune_policy("heuristic")
    _poison(monkeypatch, "heuristic")
    _matmul()
    _attention()
    assert backends.cache_stats()["measured"] == 0
    assert not os.path.exists(autotune.table_path())
    for rec in backends.autotune_report().values():
        assert rec["source"] == "heuristic" and rec["est_ms"] is None


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="unknown autotune policy"):
        backends.set_autotune_policy("fastest")
    with pytest.raises(ValueError, match="unknown autotune policy"):
        with backends.autotune_policy("bogus"):
            pass


def test_env_policy_default_validates_loudly():
    assert backends._policy_from_env(None) == "heuristic"
    for p in backends.AUTOTUNE_POLICIES:
        assert backends._policy_from_env(p) == p
    with pytest.warns(UserWarning, match="REPRO_AUTOTUNE='measured'"):
        assert backends._policy_from_env("measured") == "heuristic"


def test_policy_context_manager_restores_on_error():
    prev = backends.get_autotune_policy()
    with pytest.raises(RuntimeError):
        with backends.autotune_policy("measure"):
            assert backends.get_autotune_policy() == "measure"
            raise RuntimeError("boom")
    assert backends.get_autotune_policy() == prev


# ------------------------------------------------------- network wiring ---

def _two_conv():
    return Network(TWO_CONV_CFG, _engine(),
                   generator=torch.Generator().manual_seed(0))


def test_compile_measured_build_pass_and_report():
    net = _two_conv()
    assert backends.get_autotune_policy() == "heuristic"
    cn = net.compile(2, autotune="measure")
    assert backends.get_autotune_policy() == "heuristic"  # scoped
    rep = cn.autotune_report()
    assert len(rep) == 2                     # one conv2d key per layer
    assert all(r["source"] == "measured" for r in rep.values())
    assert cn.profile(reps=1)["autotune"] == rep
    _fresh_process()
    cn2 = net.compile(2, autotune="measure")
    st = backends.cache_stats()
    assert st["measured"] == 0 and st["persisted"] == 2
    assert {k: r["pick"] for k, r in cn2.autotune_report().items()} \
        == {k: r["pick"] for k, r in rep.items()}


def test_compile_cache_forwards_autotune_and_reports():
    cache = _two_conv().compile_cache(buckets=(1, 2), autotune="measure")
    x = torch.zeros((2, 16, 16, 3))
    cache.run(x)
    st = cache.stats()
    assert st["autotune"] == {"keys": 2, "sources": {"measured": 2}}
    cache.run(x[:1])
    assert cache.stats()["autotune"]["keys"] == 4


def test_compile_rejects_unknown_autotune_policy():
    with pytest.raises(ValueError, match="unknown autotune policy"):
        _two_conv().compile(1, autotune="bogus")


# ------------------------------------------------- against the JAX package ---

@pytest.mark.parametrize("op,shapes,dtype", [
    ("matmul", (512, 256, 128), "float32"),
    ("bmm", (64, 16, 2048, 1408), "bfloat16"),
    ("conv2d", ((2, 16, 16, 3), 8, 3, 1, 1), "float32"),
    ("attention", ((1, 64, 4, 64), (1, 64, 2, 64)), "float32"),
    ("gemm_bwd", ("dw", 896, 1024, 4864), "float32"),
])
def test_key_str_equals_the_jax_packages(op, shapes, dtype):
    assert autotune.key_str(op, shapes, dtype, "cuda") == \
        jax_autotune.key_str(op, shapes, dtype, "cuda")
    assert backends.dtype_name(getattr(torch, dtype)) == dtype


def test_reads_a_table_the_jax_package_wrote(tmp_path):
    jax_autotune.reset()
    entries = {
        jax_autotune.key_str("matmul", (48, 40, 24), "float32", "pallas"):
            {"pick": [48, 128, 128], "est_ms": 0.5,
             "candidates_timed": [[[48, 128, 128], 0.5]],
             "source": "measured"},
        jax_autotune.key_str("attention", ((1, 64, 4, 16), (1, 64, 2, 16)),
                             "float32", "pallas"):
            {"pick": [64, 128], "est_ms": 0.25, "candidates_timed": [],
             "source": "measured"}}
    try:
        for key, rec in entries.items():
            assert jax_autotune.store(key, rec)
        path = jax_autotune.table_path()
        assert os.path.dirname(path) == str(tmp_path)
        assert autotune._read_table(path) == entries
    finally:
        jax_autotune.reset()
    # the port's own table is another file: the JAX one is never served
    assert autotune.table_path() != path
    assert autotune.lookup(next(iter(entries))) is None


def test_fingerprints_differ_from_the_jax_packages():
    assert autotune.device_fingerprint() != jax_autotune.device_fingerprint()
    assert autotune.device_fingerprint() == "cpu__torch-cpu__v1"


def test_conv2d_keys_equal_the_jax_pallas_compiles():
    """The (op, shapes, dtype) keys the port's build resolves for the
    two-layer config are those the JAX `pallas` compile resolves."""
    jax_backends.clear_tile_cache()
    try:
        jnet = JaxNetwork(TWO_CONV_CFG, jax_make_engine("pallas"))
        jcn = jnet.compile(jnet.init(jax.random.PRNGKey(0)), batch_size=2)
        want = sorted(json.dumps(json.loads(k)[:3])
                      for k in jcn.autotune_keys)
    finally:
        jax_backends.clear_tile_cache()
    cn = _two_conv().compile(2)
    got = sorted(json.dumps(json.loads(k)[:3]) for k in cn.autotune_keys)
    assert got == want and len(got) == 2
    assert all(json.loads(k)[0] == "conv2d" for k in got)


# --------------------------------------------------------------- port only ---

GEMM_GRID = [(1, 896, 896), (8, 896, 4864), (33, 177, 99), (64, 4864, 896),
             (200, 1024, 1024), (1024, 896, 151936), (4096, 4096, 4096)]


@pytest.mark.parametrize("m,k,n", GEMM_GRID)
def test_heuristic_pick_is_todays_gemm_rule(m, k, n):
    assert CUDA.tiles("matmul", (m, k, n), torch.float32) == \
        gemm.plan_for(m, k, n) == ops.default_tiles(m, k, n)
    for b in (1, 16, 64):
        assert CUDA.tiles("bmm", (b, m, k, n), torch.float32) == \
            ops.bmm_plan_for(m, k, n)
    assert CUDA.tiles("conv2d", ((1, 1, m, k), n, 1, 1, 0),
                      torch.float32) == gemm.plan_for(m, k, n)
    for variant, rows, kdim, cols in (("dx", m, n, k), ("dw", k, m, n)):
        for b in (1, 64):
            shapes = ops.gemm_bwd_key(("b" if b > 1 else "") + variant,
                                      rows, kdim, cols, b)
            assert CUDA.tiles("gemm_bwd", shapes, torch.float32) == \
                gemm.bwd_plan_for(variant, rows, kdim, cols, b)
            assert ops.cached_bwd_plan(shapes[0], rows, kdim, cols,
                                       torch.float32, b) == \
                ops.bwd_plan(variant, rows, kdim, cols, b)


@pytest.mark.parametrize("d", fa.FWD_HEAD_DIMS)
def test_heuristic_pick_is_todays_attention_rule(d):
    for b, sq, skv, h, kv in ((1, 64, 64, 14, 2), (4, 64, 128, 16, 16),
                              (8, 512, 512, 14, 2), (2, 1, 100, 16, 1),
                              (2, 12, 48, 16, 1), (1, 2048, 2048, 8, 1)):
        shapes = ((b, sq, h, d), (b, skv, kv, d))
        assert CUDA.tiles("attention", shapes, "float32") == \
            fa.plan_for(b, sq, h, kv, d)
        if d in fa.BWD_HEAD_DIMS:
            assert CUDA.tiles("attention_bwd", shapes, "float32") == \
                fa.bwd_plan_for(b, sq, h, kv, d)
    shapes = ((2, 1, 16, d), (2, 528, 1, d))    # decode-shaped
    assert CUDA.tiles("attention", shapes, "float32") == ()
    assert CUDA.tiles("attention_decode", shapes, "float32") == \
        ops.decode_splits(528, 1)


@pytest.mark.parametrize("m,k,n", GEMM_GRID)
def test_candidates_are_instantiated_plans_heuristic_first(m, k, n):
    for op in ("matmul", "conv2d", "bmm"):
        cands = ops.candidate_blocks(op, m, k, n, "float32")
        base = (ops.bmm_plan_for if op == "bmm" else ops.default_tiles)(
            m, k, n)
        assert cands[0] == base and sorted(cands) == sorted(gemm.PLANS)
    for variant in ("dx", "dw", "bdx", "bdw"):
        cands = ops.candidate_gemm_bwd_blocks(variant, m, k, n, "float32", 4)
        assert cands[0] == gemm.bwd_plan_for(variant[-2:], m, k, n, 4)
        assert sorted(cands) == sorted(gemm.BWD_PLANS)
        for plan in cands:
            assert not backends.validate_tiles(
                "gemm_bwd", ops.gemm_bwd_key(variant, m, k, n, 4),
                "float32", plan)
    for d in fa.FWD_HEAD_DIMS:
        dims = (2, 64, 64, 16, 2, d)
        cands = ops.candidate_attention_blocks(*dims, "float32")
        assert cands[0] == fa.plan_for(2, 64, 16, 2, d)
        assert sorted(cands) == sorted(fa.plans_at(d))
        bcands = ops.candidate_attention_bwd_blocks(*dims, "float32")
        assert bcands == ([] if d not in fa.BWD_HEAD_DIMS else
                          [fa.bwd_plan_for(2, 64, 16, 2, d)]
                          + [p for p in fa.bwd_plans_at(d)
                             if p != fa.bwd_plan_for(2, 64, 16, 2, d)])
    assert ops.candidate_attention_blocks(2, 1, 528, 16, 1, 576,
                                          "float32") == []


def test_dw_and_decode_splits_never_vary_with_the_policy(monkeypatch):
    """Under measure the gemm_bwd keys pick a plan and keep the shape's
    split; the decode key resolves to decode_splits, nothing timed."""
    timed = []
    monkeypatch.setattr(autotune, "time_thunk",
                        lambda thunk, **kw: timed.append(1) or thunk())
    backends.register_backend(
        "cuda", dict(CUDA.ops), tile_picker=CUDA.tile_picker,
        tile_candidates=CUDA.tile_candidates, tile_bench=_stub_bench,
        differentiable=CUDA.differentiable,
        inference_only=CUDA.inference_only, overwrite=True)
    try:
        backends.set_autotune_policy("measure")
        for variant, rows, kdim, cols, b in (("dw", 896, 1024, 4864, 1),
                                             ("dx", 1024, 896, 896, 1),
                                             ("bdw", 2048, 32, 1408, 64)):
            plan, splits = ops.cached_bwd_plan(variant, rows, kdim, cols,
                                               torch.float32, b)
            want = ops.bwd_plan(variant[-2:], rows, kdim, cols, b)
            assert splits == want[1]
            assert plan == gemm.BWD_PLANS[-1]    # the stub's fastest
        n_timed = len(timed)
        q = torch.randn(2, 1, 16, 64)
        k = torch.randn(2, 300, 2, 64)
        got = ops.attention_decode(q, k, k.clone(), 300)
        assert len(timed) == n_timed              # nothing timed
        (key, rec), = [(k, r) for k, r in backends.autotune_report().items()
                       if k.startswith('["attention_decode"')]
        assert rec["source"] == "heuristic"
        assert tuple(rec["pick"]) == ops.decode_splits(300, 2)
        backends.set_autotune_policy("heuristic")
        backends.clear_tile_cache()
        assert torch.equal(got, ops.attention_decode(q, k, k.clone(), 300))
    finally:
        backends._REGISTRY["cuda"] = CUDA


@pytest.mark.parametrize("op,shapes,pick,problem", [
    ("matmul", (48, 40, 24), ["C", 32, 32], "not an instantiated"),
    ("matmul", (48, 40, 24), [8, 128], "well-formed"),
    ("bmm", (4, 48, 40, 24), ["B", 256, 256], "not an instantiated"),
    ("gemm_bwd", ("dw", 40, 48, 24), [16, 16], "not an instantiated"),
    ("attention", ((1, 64, 16, 80), (1, 64, 16, 80)), [8, 256, 32],
     "does not fit at head dim 80"),
    ("attention", ((1, 64, 4, 64), (1, 64, 2, 64)), [32, 256, 8],
     "not an instantiated"),
    ("attention_bwd", ((1, 64, 4, 64), (1, 64, 2, 64)), [32],
     "not an instantiated"),
])
def test_illegal_persisted_pick_warns_and_takes_the_heuristic(
        op, shapes, pick, problem):
    """A stale table's pick is never launched: it warns, naming the key,
    the pick and the problem, and the key takes the heuristic pick."""
    key = autotune.key_str(op, shapes, "float32", "tuned")
    assert autotune.store(key, {"pick": pick, "est_ms": 1.0,
                                "candidates_timed": [],
                                "source": "measured"})
    _fresh_process()
    backends.set_autotune_policy("measure")
    with pytest.warns(UserWarning, match=problem) as rec:
        plan = backends.get_backend("tuned").tiles(op, shapes, "float32")
    assert key in str(rec[0].message) and str(tuple(pick)) in str(
        rec[0].message)
    assert plan == CUDA.tile_picker(op, shapes, "float32")
    assert backends.autotune_report()[key]["source"] == "heuristic"


def test_measuring_while_capturing_raises(monkeypatch):
    monkeypatch.setattr(autotune, "capturing", lambda: True)
    backends.set_autotune_policy("measure")
    with pytest.raises(RuntimeError, match=r'\["matmul",\[48,40,24\],'
                       r'"float32","tuned"\] inside an active CUDA graph'):
        _matmul()
    # a persisted pick needs no timing, so it serves inside a capture
    monkeypatch.setattr(autotune, "capturing", lambda: False)
    _matmul()
    _fresh_process()
    monkeypatch.setattr(autotune, "capturing", lambda: True)
    _matmul()
    assert backends.cache_stats()["persisted"] == 1


def test_time_thunk_on_the_cpu_is_a_positive_median():
    calls = []
    t = TIME_THUNK(lambda: calls.append(sum(range(1000))), warmup=2, reps=3)
    assert t > 0 and len(calls) == 5


def test_no_card_means_nothing_is_measured():
    """The `cuda` backend's benches need a card: without one the measure
    policy resolves every key heuristically and writes no table."""
    backends.set_autotune_policy("measure")
    assert CUDA.tile_bench("matmul", (8, 8, 8), "float32",
                           gemm.PLANS[0]) is None
    plan = CUDA.tiles("matmul", (48, 40, 24), torch.float32)
    assert plan == ops.default_tiles(48, 40, 24)
    assert backends.cache_stats()["measured"] == 0
    assert not os.path.exists(autotune.table_path())


def test_the_wrappers_resolve_the_engines_keys():
    """ops.matmul / bmm / attention / attention_decode called without a
    plan resolve through the registry under the engine's keys, and the
    backward keys only under grad; the engine's bmm keys its plan with the
    batch and logs the dispatch without it."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(6, 5, generator=g), torch.randn(5, 7, generator=g)
    ops.matmul(x, w)
    ops.bmm(torch.randn(3, 6, 5, generator=g), torch.randn(3, 5, 7,
                                                           generator=g))
    q = torch.randn(1, 8, 4, 32, generator=g)
    kv = torch.randn(1, 8, 2, 32, generator=g)
    ops.attention(q, kv, kv)
    keys = set(backends.autotune_report())
    assert keys == {'["matmul",[6,5,7],"float32","cuda"]',
                    '["bmm",[3,6,5,7],"float32","cuda"]',
                    '["attention",[[1,8,4,32],[1,8,2,32]],"float32","cuda"]'}
    ops.matmul(x, w.requires_grad_()).sum().backward()
    ops.attention(q.requires_grad_(), kv, kv).sum().backward()
    new = set(backends.autotune_report()) - keys
    assert new == {'["gemm_bwd",["dx",6,7,5],"float32","cuda"]',
                   '["gemm_bwd",["dw",5,6,7],"float32","cuda"]',
                   '["attention_bwd",[[1,8,4,32],[1,8,2,32]],"float32",'
                   '"cuda"]'}
    # a decode-shaped problem called here takes the forward's own rule
    qd, kd = torch.randn(1, 1, 4, 32), torch.randn(1, 300, 2, 32)
    assert torch.equal(ops.attention(qd, kd, kd, causal=False),
                       fa.flash_attention_fwd(ops.scale_queries(qd), kd, kd,
                                              causal=False))
    assert backends.autotune_report()[
        '["attention",[[1,1,4,32],[1,300,2,32]],"float32","cuda"]'][
            "pick"] == []
    backends.reset_dispatch_counts()
    _engine().bmm(torch.randn(3, 6, 5), torch.randn(3, 5, 7))
    assert backends.dispatch_log()[0]["shapes"] == (6, 5, 7)
    assert '["bmm",[3,6,5,7],"float32","tuned"]' in backends.autotune_report()
