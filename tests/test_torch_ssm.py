"""The port's Mamba2 SSM against the JAX package, on the CPU.

The SSD scan: the port's plain chunk scan (`kernels/ssd.py::ssd_scan_plain`,
the kernel's arithmetic), its `ref` and `eager` engine ops, the `ops.ssd`
glue and the port's `ssd_reference` against the JAX Pallas kernel
(`ssd_scan` in interpret mode, padded to the chunk, heads pre-broadcast as
its wrapper does), the JAX `ssd_chunked` and `ssd_reference`, for y and the
final state, ragged S and G = 2 included.  Bar: 1e-5 max-relative.  Then
`reduced(mamba2-1.3b)` (2 layers, d 128, 8 heads of 32, state 16, chunk
32) with the JAX parameters carried across by
`convert.lm_params_from_jax`: one mixer's `ssm_forward` and `ssm_decode`
at 1e-5, the prefill step's logits and caches and a 3-token decode at
1e-4, the slot engine's greedy streams (the port resets a reused slot's
SSM state, the JAX engine does not), the config, the parameter round
trip, the refusals (the paged engine, an empty prompt, the `cuda` `ssd`
op on a CPU tensor) and the `cuda` `ssd` op passing the grad guard (it
takes the einsum form under grad); under `mixed` the prefill logits, a decode
step and the loss at 5e-2.  Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.kernels.ssd import ssd_scan as jax_ssd_scan
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tfm
from repro.models.common import lm_head_logits as jax_lm_head_logits
from repro.serve import kvcache as jax_kvcache
from repro.serve import serve_step as jax_serve_step
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import ComputeEngine, backends, make_engine
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.serve import frontend as fe
from repro_torch.serve import kvcache, serve_step
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine

torch.set_num_threads(1)

TOL = 1e-5
LM_TOL = 1e-4
MIXED_TOL = 5e-2  # the bf16 bar of tests/test_grad_conformance.py
MARGIN = 1e-3
ENGINE = make_engine("eager", device="cpu")
REF = make_engine("ref", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
ARCH = "mamba2-1.3b"

# (batch, S, H, P, G, N, chunk): S a multiple of the chunk, ragged, G = 2,
# a chunk longer than S
SSD_CASES = [(2, 64, 4, 16, 1, 8, 16), (2, 50, 4, 8, 2, 16, 16),
             (1, 37, 2, 8, 2, 8, 32), (2, 20, 4, 8, 1, 8, 32)]


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _ssd_inputs(b, s, h, p, g, n, seed, init=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 0.5)).astype(
        np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32) if init
          else None)
    return x, dt, a, bm, cm, st


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_kernel_y(x, dt, a, bm, cm, chunk):
    """y of the JAX Pallas kernel (interpret mode) through its wrapper's
    layout: rows padded with dt = 0 to a multiple of the chunk, heads
    flattened into the grid axis, groups broadcast to the heads."""
    b, s, h, p = x.shape
    g, n = bm.shape[2:]
    pad = -s % chunk
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (x, dt, bm, cm)]
    x, dt, bm, cm = padded
    sp = s + pad
    xk = x.transpose(0, 2, 1, 3).reshape(b * h, sp, p)
    dtk = dt.transpose(0, 2, 1).reshape(b * h, sp)
    dak = dtk * np.tile(a, b)[:, None]
    heads = np.arange(h) // (h // g)
    bk = bm[:, :, heads].transpose(0, 2, 1, 3).reshape(b * h, sp, n)
    ck = cm[:, :, heads].transpose(0, 2, 1, 3).reshape(b * h, sp, n)
    y = jax_ssd_scan(*map(jnp.asarray, (xk, dtk, dak, bk, ck)), chunk=chunk,
                     interpret=True)
    return np.asarray(y).reshape(b, h, sp, p).transpose(0, 2, 1, 3)[:, :s]


def _port_ssd(how, x, dt, a, bm, cm, chunk, st):
    args = tuple(map(_t, (x, dt, a, bm, cm)))
    if how == "plain":
        xt, dtt, at, bt, ct = args
        return ssd_kernel.ssd_scan_plain(xt, dtt, dtt * at, bt, ct,
                                         chunk=chunk, init_state=_t(st))
    if how == "wrapper":
        return ops.ssd(*args, chunk=chunk, init_state=_t(st))
    if how == "reference":
        return ssm.ssd_reference(*args, init_state=_t(st))
    return {"ref": REF, "eager": ENGINE}[how].ssd(*args, chunk=chunk,
                                                  init_state=_t(st))


@pytest.mark.parametrize("how", ["plain", "wrapper", "ref", "eager",
                                 "reference"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_the_jax_formulations(case, how):
    b, s, h, p, g, n, chunk = case
    x, dt, a, bm, cm, _ = _ssd_inputs(b, s, h, p, g, n, seed=s + g)
    y, st = _port_ssd(how, x, dt, a, bm, cm, chunk, None)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    assert st.dtype == torch.float32
    jy, jst = jax_ssm.ssd_chunked(JAX_ENGINE, *map(jnp.asarray,
                                                   (x, dt, a, bm, cm)), chunk)
    ry, rst = jax_ssm.ssd_reference(*map(jnp.asarray, (x, dt, a, bm, cm)))
    assert _relmax(y, jy) <= TOL and _relmax(st, jst) <= TOL
    assert _relmax(y, ry) <= TOL and _relmax(st, rst) <= TOL
    if how == "plain":  # the Pallas kernel itself (y only: no state out)
        assert _relmax(y, _jax_kernel_y(x, dt, a, bm, cm, chunk)) <= TOL


@pytest.mark.parametrize("how", ["plain", "ref", "eager", "reference"])
def test_ssd_scan_from_an_initial_state_matches_jax(how):
    x, dt, a, bm, cm, st0 = _ssd_inputs(2, 45, 4, 8, 2, 8, seed=7, init=True)
    y, st = _port_ssd(how, x, dt, a, bm, cm, 16, st0)
    args = tuple(map(jnp.asarray, (x, dt, a, bm, cm)))
    jy, jst = jax_ssm.ssd_chunked(JAX_ENGINE, *args, 16,
                                  init_state=jnp.asarray(st0))
    assert _relmax(y, jy) <= TOL and _relmax(st, jst) <= TOL


def test_ssd_split_at_any_row_carries_the_state():
    """Two scans, the second from the first's final state, give the scan
    of the whole sequence (what a chunked prefill would rely on)."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 48, 2, 8, 1, 8, seed=3)
    y, st = _port_ssd("plain", x, dt, a, bm, cm, 16, None)
    cut = 21
    y1, st1 = _port_ssd("plain", *(t[:, :cut] for t in (x, dt)), a,
                        *(t[:, :cut] for t in (bm, cm)), 16, None)
    y2, st2 = _port_ssd("plain", *(t[:, cut:] for t in (x, dt)), a,
                        *(t[:, cut:] for t in (bm, cm)), 16, st1.numpy())
    assert _relmax(torch.cat([y1, y2], 1), y) <= TOL
    assert _relmax(st2, st) <= TOL


def test_ssd_wrappers_refuse_what_they_do_not_take():
    x, dt, a, bm, cm, _ = map(_t, _ssd_inputs(1, 8, 4, 8, 1, 8, seed=0))
    with pytest.raises(ValueError, match="divide"):
        ENGINE.ssd(x, dt, a, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8),
                   chunk=4)
    with pytest.raises(ValueError, match="dt must be"):
        ENGINE.ssd(x, dt[:, :4], a, bm, cm, chunk=4)
    with pytest.raises(TypeError, match="share"):
        ssd_kernel.ssd_scan(x, dt, dt, bm.double(), cm, chunk=4)
    with pytest.raises(ValueError, match="init_state"):
        ssd_kernel.ssd_scan(x, dt, dt, bm, cm, chunk=4,
                            init_state=torch.zeros(1, 4, 8, 4))
    before = ssd_kernel.launches
    ssd_kernel.ssd_scan(x, dt, dt, bm, cm, chunk=4)   # CPU: the plain version
    assert ssd_kernel.launches == before


def test_ref_ssd_gradient_is_finite_where_the_decay_overflows():
    """The `ref` op (the kernel's plain chunk scan) under grad at a chunk
    whose cumulative decay leaves fp32's exp range above the diagonal
    (cs spans about 190): its gradients are finite and equal the `eager`
    einsum form's within 1e-5, as the forward does."""
    x, dt, a, bm, cm, st = _ssd_inputs(2, 64, 4, 8, 1, 8, seed=9, init=True)
    a = a * 5
    w = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)
    out = {}
    for name, eng in (("ref", REF), ("eager", ENGINE)):
        leaves = [_t(t).requires_grad_() for t in (x, dt, bm, cm, st)]
        xt, dtt, bt, ct, stt = leaves
        y, fin = eng.ssd(xt, dtt, _t(a), bt, ct, chunk=64, init_state=stt)
        loss = (y * _t(w)).sum() + fin.sum()
        out[name] = (y, torch.autograd.grad(loss, leaves))
    assert _relmax(out["ref"][0].detach(), out["eager"][0].detach()) <= TOL
    for g, want in zip(out["ref"][1], out["eager"][1]):
        assert bool(torch.isfinite(g).all())
        assert _relmax(g, want) <= TOL


def test_cuda_ssd_passes_the_grad_guard_and_refuses_the_cpu():
    """The SSD kernel has no backward (the JAX kernel has no VJP): under
    grad the `cuda` backend's ssd takes the einsum form the JAX package
    trains through, so `guard_grad` lets every ssd dispatch pass; given a
    CPU tensor the op raises, with grad or without, never falls back and
    counts nothing; `reset_launches` zeroes the kernel's count and the
    einsum form's.  `eager` differentiates it.  The einsum form itself
    runs on the card (tests/test_torch_cuda.py)."""
    x, dt, a, bm, cm, _ = map(_t, _ssd_inputs(1, 8, 4, 8, 1, 8, seed=1))
    cuda = ComputeEngine(backend="cuda", device=torch.device("cpu"))
    xg = x.clone().requires_grad_()
    backends.guard_grad(backends.get_backend("cuda"), "ssd", xg, dt)
    before = (ssd_kernel.launches, ssd_kernel.einsum_dispatches)
    for t in (xg, x):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda.ssd(t, dt, a, bm, cm, chunk=4)
    assert (ssd_kernel.launches, ssd_kernel.einsum_dispatches) == before
    y, _ = ENGINE.ssd(xg, dt, a, bm, cm, chunk=4)
    (gx,) = torch.autograd.grad(y.sum(), (xg,))
    assert bool(torch.isfinite(gx).all())
    saved = (ssd_kernel.launches, ssd_kernel.einsum_dispatches)
    try:
        ssd_kernel.launches, ssd_kernel.einsum_dispatches = 2, 3
        ssd_kernel.reset_launches()
        assert (ssd_kernel.launches, ssd_kernel.einsum_dispatches) == (0, 0)
    finally:
        ssd_kernel.launches, ssd_kernel.einsum_dispatches = saved


# ---------------------------------------------------------- the mixer / LM ---

@pytest.fixture(scope="module")
def lm():
    jcfg = jax_base.reduced(jax_base.get_arch(ARCH))
    cfg = base.reduced(base.get_arch(ARCH))
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    # non-trivial dt bias, A and D, so every parameter reaches the output
    rng = np.random.default_rng(1)
    mixer = jparams["stacks"][0]["mixer"]
    for name, scale in (("dt_bias", 0.5), ("A_log", 0.3), ("D", 0.5)):
        mixer[name] = mixer[name] + jnp.asarray(rng.standard_normal(
            mixer[name].shape).astype(np.float32) * scale)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.lm_params_from_jax(tree, cfg)


def test_config_equals_the_jax_config():
    mine, theirs = base.get_arch(ARCH), jax_base.get_arch(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (dataclasses.asdict(base.reduced(mine))
            == dataclasses.asdict(jax_base.reduced(theirs)))
    assert (mine.ssm_nheads, mine.ssm_d_inner, mine.vocab_padded) == (
        64, 4096, 50288)
    assert tfm.stack_program(mine) == [("mamba", 48)]


def test_params_round_trip_through_the_jax_layout(lm):
    jcfg, cfg, jparams, params = lm
    back = convert.lm_params_to_numpy(params, cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(x, y) for x, y in zip(flat_a, flat_b))
    assert set(params["layers"][0]) == {"norm", "mixer"}
    assert params["layers"][1]["mixer"]["wx"].shape == (128, 256)


def test_port_init_has_the_jax_tree_shapes(lm):
    jcfg, cfg, jparams, _ = lm
    mine = convert.lm_params_to_numpy(tfm.init_params(
        cfg, generator=torch.Generator().manual_seed(0)), cfg)
    want = jax.tree_util.tree_map(lambda t: t.shape, jparams)
    assert jax.tree_util.tree_map(lambda t: t.shape, mine) == want


def _layer0(jparams, params):
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["stacks"][0])
    return jp["mixer"], params["layers"][0]["mixer"]


def test_ssm_forward_and_decode_match_jax(lm):
    jcfg, cfg, jparams, params = lm
    jp, p = _layer0(jparams, params)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    jout, jcache = jax_ssm.ssm_forward(JAX_ENGINE, jp, jnp.asarray(x), jcfg,
                                       return_cache=True)
    out, cache = ssm.ssm_forward(ENGINE, p, torch.from_numpy(x), cfg,
                                 return_cache=True)
    assert _relmax(out, jout) <= TOL
    for name in ssm.CACHE_KEYS:
        assert cache[name].shape == jcache[name].shape, name
        assert _relmax(cache[name], jcache[name]) <= TOL, name
    xn = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jd, jnew = jax_ssm.ssm_decode(JAX_ENGINE, jp, jnp.asarray(xn), jcache,
                                  jcfg)
    d, new = ssm.ssm_decode(ENGINE, p, torch.from_numpy(xn), cache, cfg)
    assert _relmax(d, jd) <= TOL
    for name in ssm.CACHE_KEYS:
        assert _relmax(new[name], jnew[name]) <= TOL, name


def test_decode_after_prefill_continues_the_sequence(lm):
    """The O(1) recurrence from the prefill's cache gives the mixer output
    of the full sequence at the next row."""
    _, cfg, _, params = lm
    p = params["layers"][0]["mixer"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 34, cfg.d_model)).astype(np.float32))
    full = ssm.ssm_forward(ENGINE, p, x, cfg)
    _, cache = ssm.ssm_forward(ENGINE, p, x[:, :33], cfg, return_cache=True)
    step, _ = ssm.ssm_decode(ENGINE, p, x[:, 33:], cache, cfg)
    assert _relmax(step, full[:, 33:]) <= TOL


def test_cache_init_matches_the_jax_cache_struct(lm):
    jcfg, cfg, _, _ = lm
    want = jax_kvcache.cache_struct(jcfg, 3, 16)
    got = kvcache.cache_init(cfg, 3, 16)
    assert [{k: tuple(v.shape) for k, v in e.items()} for e in got] == [
        {k: tuple(v.shape) for k, v in e.items()} for e in want]
    assert all(bool((v == 0).all()) for v in got[0].values())


def test_prefill_and_decode_steps_match_jax(lm):
    jcfg, cfg, jparams, params = lm
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jlogits, jcaches = jax_serve_step.make_prefill_step(JAX_ENGINE, jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, caches = serve_step.make_prefill_step(ENGINE, cfg)(
            params, {"tokens": torch.from_numpy(tokens).long()})
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= LM_TOL
    for name in ssm.CACHE_KEYS:
        assert caches[0][name].shape == jcaches[0][name].shape
        assert _relmax(caches[0][name], jcaches[0][name]) <= LM_TOL, name
    jdecode = jax_serve_step.make_decode_step(JAX_ENGINE, jcfg)
    decode = serve_step.make_decode_step(ENGINE, cfg)
    nxt = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)
    for i in range(3):
        pos = tokens.shape[1] + i
        jlogits, jcaches = jdecode(jparams, jcaches, jnp.asarray(nxt[:, None]),
                                   jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            logits, caches = decode(params, caches,
                                    torch.from_numpy(nxt[:, None]).long(),
                                    pos)
        assert _relmax(logits, jlogits) <= LM_TOL, i
        for name in ssm.CACHE_KEYS:
            assert _relmax(caches[0][name], jcaches[0][name]) <= LM_TOL
        nxt = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)


def test_mamba_decode_takes_one_token(lm):
    _, cfg, _, params = lm
    caches = kvcache.cache_init(cfg, 1, 8)
    with pytest.raises(ValueError, match="one token"):
        tfm.decode_hidden(ENGINE, cfg, params, caches,
                          torch.zeros(1, 2, dtype=torch.long), 0)


def test_paged_engine_refuses_the_ssm_stack(lm):
    _, cfg, _, params = lm
    with pytest.raises(NotImplementedError, match="dense GQA"):
        PagedServingEngine(cfg, params, engine=ENGINE, kv_blocks=8,
                           block_size=8, max_len=32, chunk=4)


# ------------------------------------------------------------ slot engine ---

def _stream(cls, cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(3, 12))
                                           ).tolist(),
                max_new=int(rng.integers(2, 6)))
            for i in range(n)]


def _margins(jcfg, jparams, req) -> list[float]:
    """Teacher-forced JAX top-2 margins of a request served alone."""
    seq = req.prompt + req.out[:-1]
    h, _ = jax_tfm.forward_hidden(JAX_ENGINE, jcfg, jparams,
                                  tokens=jnp.asarray([seq], jnp.int32))
    logits = np.asarray(jax_lm_head_logits(
        JAX_ENGINE, h, jax_tfm.head_weight(jparams, jcfg),
        vocab_real=jcfg.vocab_size))[0][len(req.prompt) - 1:]
    assert [int(t) for t in logits.argmax(-1)] == req.out
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]).tolist()


@pytest.fixture(scope="module")
def served(lm):
    """Five requests through two slots (three of them in a reused slot),
    on the JAX engine, and each request alone on a fresh JAX engine."""
    jcfg, cfg, jparams, params = lm
    shared = _stream(JaxRequest, jcfg, 5, seed=0)
    JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=2,
                     max_len=32).run(shared)
    alone = []
    for r in _stream(JaxRequest, jcfg, 5, seed=0):
        JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=1,
                         max_len=32).run([r])
        assert min(_margins(jcfg, jparams, r)) > MARGIN
        alone.append(r.out)
    return cfg, params, [r.out for r in shared], alone


def test_slot_engine_resets_a_reused_slot(served):
    """Each request's stream on the port equals its stream alone (JAX and
    port): the slot's conv tails and state are zeroed at admission, and
    its prompt runs through the prefill (the SSD op) into the slot."""
    cfg, params, _, alone = served
    reqs = _stream(Request, cfg, 5, seed=0)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32)
    snap = backends.dispatch_counts()
    slot.run(reqs)
    assert [r.out for r in reqs] == alone
    # every prompt (all longer than one token) was prefilled by the SSD op
    assert backends.counts_since(snap)[("eager", "ssd")] == 5 * cfg.n_layers
    for r, want in zip(_stream(Request, cfg, 5, seed=0), alone):
        ServingEngine(cfg, params, engine=ENGINE, slots=1,
                      max_len=32).run([r])
        assert r.out == want
    st = slot.stats()
    assert st["requests"]["completed"] == 5
    assert st["op_counts"] == {("eager", "matmul"): 6 * cfg.n_layers + 1}


def test_slot_engine_equals_the_jax_engine_on_first_use_slots(served):
    cfg, params, shared, _ = served
    reqs = _stream(Request, cfg, 5, seed=0)
    ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32).run(reqs)
    assert [r.out for r in reqs[:2]] == shared[:2]


def test_dense_slot_rows_are_left_alone(lm):
    """Admission zeroes only mamba entries (the slot's rows, not the
    others'): a dense engine's caches keep their rows."""
    dcfg = base.reduced(base.get_arch("qwen2-0.5b"))
    dparams = tfm.init_params(dcfg, generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(dcfg, dparams, engine=ENGINE, slots=2, max_len=8)
    eng.caches[0]["k"].fill_(1.0)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=1))
    eng._admit()
    assert bool((eng.caches[0]["k"] == 1.0).all())
    _, cfg, _, params = lm
    eng = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=8)
    for t in eng.caches[0].values():
        t.fill_(1.0)
    eng.submit(Request(rid=0, prompt=[1], max_new=1))  # nothing to prefill
    eng._admit()
    for t in eng.caches[0].values():
        assert bool((t[:, 0] == 0).all()) and bool((t[:, 1] == 1.0).all())


def test_a_reused_slot_matches_the_request_alone_where_jax_does_not(lm):
    """The reference's quirk, pinned: the JAX slot engine resets only the
    position at admission, so a mamba request after another in the same
    slot starts from the old conv tails and state.  The port's stream
    there equals the request alone."""
    jcfg, cfg, _, params = lm
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    prompt, other = [3, 17, 4, 8], [5, 9, 11]
    runs = {}
    for label, cls, make in (
            ("jax", JaxRequest, lambda: JaxServingEngine(
                jcfg, jparams, engine=JAX_ENGINE, slots=1, max_len=32)),
            ("port", Request, lambda: ServingEngine(
                cfg, params, engine=ENGINE, slots=1, max_len=32))):
        alone = cls(rid=0, prompt=prompt, max_new=6)
        make().run([alone])
        after = cls(rid=2, prompt=prompt, max_new=6)
        make().run([cls(rid=1, prompt=other, max_new=4), after])
        runs[label] = (alone.out, after.out)
    assert runs["jax"][0] == runs["port"][0] == runs["port"][1]
    assert runs["jax"][1] != runs["jax"][0]


def test_mixed_policy_matches_jax(lm):
    """`mixed` on `eager` against JAX `xla` `mixed`: prefill logits, one
    decode step from the prefill's caches (fed JAX's greedy token) and the
    training loss, at the bf16 bar.  The rounding differs by design: the
    port's `ssd` op runs x, B and C in bf16 and returns y in bf16, where
    the JAX mixer feeds its einsum scan the fp32 conv outputs."""
    jcfg, cfg, jparams, params = lm
    jeng = jax_make_engine("xla", "mixed")
    eng = make_engine("eager", "mixed", device="cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jlogits, jcaches = jax_serve_step.make_prefill_step(jeng, jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, caches = serve_step.make_prefill_step(eng, cfg)(
            params, {"tokens": torch.from_numpy(tokens).long()})
    assert logits.dtype == torch.float32
    assert _relmax(logits, jlogits) <= MIXED_TOL
    nxt = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    jdec = jax_serve_step.make_decode_step(jeng, jcfg)(
        jparams, jcaches, jnp.asarray(nxt), jnp.asarray(32, jnp.int32))[0]
    with torch.inference_mode():
        dec, _ = serve_step.make_decode_step(eng, cfg)(
            params, caches, torch.from_numpy(nxt).long(), 32)
    assert _relmax(dec, jdec) <= MIXED_TOL
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jloss = jax_tfm.loss_fn(jeng, jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=False, ce_chunk=16)
    with torch.no_grad():
        loss = tfm.loss_fn(eng, cfg, params,
                           {k: torch.from_numpy(v).long()
                            for k, v in batch.items()},
                           remat=False, ce_chunk=16)
    assert abs(loss.item() - float(jloss)) <= MIXED_TOL * abs(float(jloss))


def test_slot_engine_refuses_an_empty_prompt(served):
    """An empty prompt would decode the slot's previous occupant's last
    token (the JAX slot engine does, ROADMAP); the port refuses it at
    submit, as the paged engine does, counts it rejected, and the request
    served after the refusal in the same slot gets its stream alone."""
    cfg, params, _, alone = served
    reqs = _stream(Request, cfg, 2, seed=0)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=1, max_len=32)
    slot.run(reqs[:1])
    with pytest.raises(fe.RejectedRequest, match="empty prompt"):
        slot.submit(Request(rid=9, prompt=[], max_new=4))
    assert not slot.pending
    slot.run(reqs[1:])
    assert [r.out for r in reqs] == alone[:2]
    st = slot.stats()
    assert (st["requests"]["rejected"], st["requests"]["completed"]) == (1, 2)
