"""The port's compile cache and CNN serving frontend, on the CPU.

`CompileCache` pads a ragged batch to its bucket, dispatches once and
slices; `CNNServingEngine` drains ragged bursts through it.  The served
results are held against an exact-batch run of the same network (1e-6:
on the CPU ``torch.matmul`` may pick its kernel by M, so padded rows need
not be bitwise equal there; on the card the kernel makes them so, which
chip_smoke.py checks) and against the JAX package's network on the same
parameters and images (1e-4).  The stats schema and the seeded latency
reservoir are held against the JAX frontend's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jax_make_engine
from repro.core.darknet.network import Network as JaxNetwork
from repro.serve import frontend as jax_fe
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.convert import params_from_jax
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import CompileCache, Network
from repro_torch.serve import frontend as fe

torch.set_num_threads(1)

BUCKETS = (1, 2, 4, 8)
BURSTS = (1, 3, 8, 2, 9, 4, 1, 5)  # examples/serve_cnn.py


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def nets():
    """(JAX network, its params, the port's network with those params)."""
    jnet = JaxNetwork(DARKNET_SMALL_CFG, jax_make_engine("xla"))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jnet.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for leaves in tree.values():
        if "gamma" in leaves:
            n = leaves["gamma"].shape[0]
            leaves.update(gamma=rng.uniform(0.5, 1.5, n).astype(np.float32),
                          beta=rng.normal(0, .1, n).astype(np.float32),
                          mean=rng.normal(0, .1, n).astype(np.float32),
                          var=rng.uniform(0.5, 1.5, n).astype(np.float32))
    net = Network(DARKNET_SMALL_CFG, make_engine("eager", device="cpu"))
    net.load_state_dict(params_from_jax(tree))
    return jnet, jax.tree_util.tree_map(jnp.asarray, tree), net


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 28, 28, 3)).astype(np.float32)


def test_cache_pads_to_bucket_slices_and_builds_each_bucket_once(nets):
    _, _, net = nets
    cache = net.compile_cache(buckets=(4, 1, 2, 8, 2))
    assert cache.buckets == BUCKETS
    assert [cache.bucket_for(n) for n in (1, 2, 3, 5, 8, 9)] == \
        [1, 2, 4, 8, 8, None]
    x = torch.from_numpy(_images(sum(BURSTS)))
    start = 0
    for n in BURSTS:
        xb = x[start:start + n]
        start += n
        y = cache.run(xb)
        assert tuple(y.shape) == (n, 10)
        with torch.inference_mode():
            exact = net(xb)
        assert _relmax(y.numpy(), exact.numpy()) <= 1e-6
    st = cache.stats()
    assert st["compiled"] == BUCKETS and st["traces"] == 4
    assert st["misses"] == 4 and st["hits"] == 9 - 4
    # 9 splits into 8 + 1; 3 and 5 pad to 4 and 8.
    assert st["dispatches"] == {1: 3, 4: 2, 8: 3, 2: 1}
    assert st["rows_real"] == 33 and st["rows_padded"] == 1 + 3 + 0
    assert math.isclose(st["pad_waste"], 4 / 37)


def test_padded_rows_are_row_independent(nets):
    """Rows of a padded bucket equal the same rows run alone."""
    _, _, net = nets
    cache = net.compile_cache(buckets=(8,))
    x = torch.from_numpy(_images(3, seed=4))
    padded = cache.run(x)
    with torch.inference_mode():
        alone = torch.cat([net(x[i:i + 1]) for i in range(3)])
    assert _relmax(padded.numpy(), alone.numpy()) <= 1e-6


def test_cache_validates_and_warms(nets):
    _, _, net = nets
    cache = net.compile_cache(buckets=(1, 2))
    with pytest.raises(ValueError, match="empty"):
        cache.run(torch.zeros((0, 28, 28, 3)))
    with pytest.raises(ValueError, match="dtype"):
        cache.run(torch.zeros((1, 28, 28, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="not a bucket"):
        cache.get(3)
    with pytest.raises(ValueError, match="positive"):
        CompileCache(net, buckets=(0, 2))
    assert cache.warmup() is cache
    assert cache.stats()["compiled"] == (1, 2) and cache.trace_count == 2
    # An oversize batch runs in top-bucket chunks without new builds.
    y = cache.run(torch.from_numpy(_images(5, seed=2)))
    assert tuple(y.shape) == (5, 10) and cache.stats()["misses"] == 2


def test_serving_engine_answers_ragged_bursts_like_jax(nets):
    jnet, jparams, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=BUCKETS))
    images = _images(sum(BURSTS), seed=7)
    reqs, rid = [], 0
    for n in BURSTS:
        burst = [fe.ImageRequest(rid=rid + i, image=images[rid + i])
                 for i in range(n)]
        rid += n
        server.run(burst)
        assert all(r.done and r.result is not None for r in burst)
        reqs += burst
    st = server.stats()
    assert set(fe.STATS_KEYS) <= set(st)
    assert st["engine"] == "cnn" and st["images"] == 33
    assert st["requests"] == {"submitted": 33, "completed": 33,
                              "rejected": 0, "truncated": 0}
    assert st["steps"] == 9 and st["throughput"] > 0
    cs = st["cache"]
    assert cs["misses"] == len(cs["compiled"]) == cs["traces"] == 4
    lat = st["latency_s"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
    assert all(r.latency_s > 0 for r in reqs)
    served = np.stack([r.result for r in reqs])
    want = np.asarray(jnet.apply(jparams, jnp.asarray(images)))
    assert _relmax(served, want) <= 1e-4


def _requests(images, start=0):
    return [fe.ImageRequest(rid=start + i, image=im)
            for i, im in enumerate(images)]


def _assert_served_like_cache_run(server, batch):
    """Each result of `batch` is byte-equal to `cache.run` on the same
    stacked images (the same batch size, so the same kernels)."""
    assert all(r.done for r in batch)
    x = torch.from_numpy(np.stack([r.image for r in batch]))
    want = server.cache.run(x).numpy()
    for r, w in zip(batch, want):
        assert r.result.tobytes() == w.tobytes()


def _staging(server):
    st = server.stats()["staging"]
    return st["rows_ahead"], st["rows_staged"]


def test_closed_loop_takes_every_batch_but_the_first_from_the_look_ahead(
        nets):
    """Two top buckets kept waiting, six steps, then a drain: every step
    after the first finds its batch staged by the one before."""
    _, _, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=BUCKETS))
    top = server.max_batch
    reqs = _requests(_images(2 * top + 5 * top, seed=11))
    arriving, batches = iter(reqs), []
    for _ in range(6):
        while len(server.pending) < 2 * top:
            server.submit(next(arriving))
        batches.append(list(server.pending)[:top])
        assert server.step() == top
    while server.pending:
        batches.append(list(server.pending)[:top])
        server.step()
    assert all(r.done for r in reqs)
    for batch in batches:
        _assert_served_like_cache_run(server, batch)
    assert _staging(server) == (len(reqs) - top, len(reqs))


def test_bursts_through_the_staging_ring_match_the_exact_batch(nets):
    """BURSTS submitted one per step: the queue outgrows the top bucket,
    look-aheads engage, later requests join a staged batch's tail."""
    _, _, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=BUCKETS))
    images = _images(sum(BURSTS), seed=12)
    reqs = _requests(images)
    start = 0
    for n in BURSTS:
        for r in reqs[start:start + n]:
            server.submit(r)
        start += n
        server.step()
    while server.step():
        pass
    assert all(r.done for r in reqs)
    ahead, staged = _staging(server)
    assert staged == len(reqs) and 0 < ahead < staged
    with torch.inference_mode():
        exact = net(torch.from_numpy(images)).numpy()
    assert _relmax(np.stack([r.result for r in reqs]), exact) <= 1e-6


def test_requests_after_a_look_ahead_join_the_staged_batch(nets):
    _, _, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=BUCKETS))
    top = server.max_batch
    images = _images(top + 7, seed=13)
    reqs = _requests(images)
    for r in reqs[:top + 3]:
        server.submit(r)
    assert server.step() == top           # stages the 3 left waiting
    for r in reqs[top + 3:]:
        server.submit(r)
    assert server.step() == 7             # 3 staged ahead + 4 stacked now
    assert _staging(server) == (3, top + 7)
    _assert_served_like_cache_run(server, reqs[:top])
    _assert_served_like_cache_run(server, reqs[top:])


def test_a_changed_queue_head_is_staged_afresh(nets):
    _, _, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=BUCKETS))
    top = server.max_batch
    reqs = _requests(_images(2 * top + 4, seed=14))
    for r in reqs:
        server.submit(r)
    assert server.step() == top           # stages reqs[top:2 * top]
    removed = server.pending.popleft()
    assert removed is reqs[top]
    assert server.step() == top           # reqs[top + 1:2 * top + 1]
    assert _staging(server) == (0, 2 * top)
    assert server.step() == 3             # the second step's look-ahead
    assert _staging(server) == (3, 2 * top + 3)
    assert not removed.done
    for batch in (reqs[:top], reqs[top + 1:2 * top + 1], reqs[2 * top + 1:]):
        _assert_served_like_cache_run(server, batch)


def test_an_open_loop_that_drains_each_step_never_looks_ahead(nets):
    _, _, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=BUCKETS))
    reqs = _requests(_images(sum(BURSTS[:4]), seed=15))
    start = 0
    for n in BURSTS[:4]:                  # each at most the top bucket
        batch = reqs[start:start + n]
        start += n
        for r in batch:
            server.submit(r)
        while server.step():
            pass
        _assert_served_like_cache_run(server, batch)
    assert _staging(server) == (0, len(reqs))


def test_bad_requests_are_rejected_and_skipped(nets):
    _, _, net = nets
    server = fe.CNNServingEngine(net.compile_cache(buckets=(1, 2)))
    with pytest.raises(fe.RejectedRequest):
        server.submit(fe.ImageRequest(rid=0, image=np.zeros((28, 28, 1))))
    assert isinstance(fe.RejectedRequest("x"), ValueError)
    good = fe.ImageRequest(rid=1, image=_images(1)[0])
    bad = fe.ImageRequest(rid=2, image=np.zeros((27, 28, 3), np.float32))
    ragged = fe.ImageRequest(rid=3, image=[[1.0], [1.0, 2.0]])
    server.run([good, bad, ragged])
    assert good.done and not bad.done and not ragged.done
    assert math.isnan(bad.latency_s)
    st = server.stats()
    assert st["requests"]["rejected"] == 3
    assert st["requests"]["completed"] == st["requests"]["submitted"] == 1
    assert server.step() == 0


def test_latency_reservoir_matches_jax_frontend():
    rng = np.random.default_rng(0)
    samples = rng.exponential(0.01, 500).tolist()
    got, want = fe.LatencyAgg(reservoir=64), jax_fe.LatencyAgg(reservoir=64)
    for s in samples:
        got.add(s)
        want.add(s)
    assert got.summary() == want.summary()
    assert got.count == 500 and got.max == max(samples)
    with pytest.raises(ValueError, match="non-finite"):
        got.add(float("nan"))
    with pytest.raises(ValueError):
        fe.LatencyAgg(reservoir=0)
    assert fe.LatencyAgg().summary()["p99"] == 0.0


def test_stats_schema_matches_jax_frontend():
    assert fe.STATS_KEYS == jax_fe.STATS_KEYS
    assert fe.REQUEST_KEYS == jax_fe.REQUEST_KEYS
    assert fe.LATENCY_KEYS == jax_fe.LATENCY_KEYS
    agg, jagg = fe.LatencyAgg(), jax_fe.LatencyAgg()
    for s in (0.1, 0.3, 0.2):
        agg.add(s)
        jagg.add(s)
    kw = dict(engine="cnn", submitted=4, completed=3, rejected=1,
              truncated=0, steps=2, wall_s=0.5, items=3,
              extra={"images": 3})
    assert fe.build_stats(latency=agg, **kw) == \
        jax_fe.build_stats(latency=jagg, **kw)
    assert fe.build_stats(latency=agg, **{**kw, "wall_s": 0.0})[
        "throughput"] == 0.0
