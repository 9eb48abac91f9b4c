"""The port's MLA family (deepseek-v2-lite-16b) against the JAX package, on
the CPU.

`reduced(deepseek-v2-lite-16b)` (2 layers: one `mla_dense`, one `mla_moe`;
d 128, 4 heads, latent 32, nope 32, rope 16, v 32; 4 experts of d_ff 128,
top-2, one shared expert, untied head), the JAX parameters carried across
with `convert.lm_params_from_jax`, inputs from numpy seeds.  The port runs
on `eager` (and `ref`), JAX on `xla` (its layers and models under
`jax.jit`: one compile in place of one per op).  Bars: 1e-5 max-relative for one op
or one layer in fp32, 1e-4 for the two-layer model (logits, caches, a
3-token decode, the loss).  The MoE layer's routes are compared first:
each MoE call's expert ids, the JAX router on the port's layer input,
with a top-k margin no rounding can cross.  The `cuda` einsum's
formulation (`backends.einsum_as_bmm`, y permuted to (E, K, N)) runs here
through the bmm wrapper's plain version; the attention kernels' wrappers
at MLA's head dims (the forward at 192 and 576, the decode at 576) run
their plain versions, against the JAX Pallas kernels in interpret mode.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_with_lse
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tfm
from repro.models.common import rope_table as jax_rope_table
from repro.serve import kvcache as jax_kvcache
from repro.serve import serve_step as jax_serve_step
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import ComputeEngine, backends, make_engine
from repro_torch.core.precision import Precision
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.common import rope_table
from repro_torch.serve import kvcache, serve_step
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
OP_TOL = 1e-5
TOL = 1e-4
ROUTE_MARGIN = 1e-3  # the least gap of the k-th over the (k+1)-th prob
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
# the absorbed decode's einsums: x (B, Q, H, ·), y (R, H, ·)
SPECS = {"bqhn,rhn->bqhr": ((2, 3, 4, 8), (6, 4, 8)),
         "bqhr,rhv->bqhv": ((2, 3, 4, 6), (6, 4, 5))}


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _configs():
    return (jax_base.reduced(jax_base.get_arch(ARCH)),
            base.reduced(base.get_arch(ARCH)))


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = _configs()
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.lm_params_from_jax(tree, cfg)


class _Routes:
    """While active, records each MoE call's layer input and the port's
    expert ids (wrapping `models.moe.route`)."""

    def __enter__(self):
        self.calls, self._route = [], moe.route

        def route(engine, p, x, cfg):
            out = self._route(engine, p, x, cfg)
            self.calls.append((p, x.detach().clone(), out[1]))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _assert_routes_match_jax(calls, k):
    """Every recorded MoE call: the port's expert ids equal JAX's router
    (its engine's GEMM, softmax, top_k) on the same layer input, with the
    k-th probability clear of the (k+1)-th by ROUTE_MARGIN."""
    assert calls
    for p, x, idx in calls:
        scores = JAX_ENGINE.matmul(jnp.asarray(x.numpy()),
                                   jnp.asarray(p["router"].numpy()),
                                   out_dtype=jnp.float32)
        probs = jax.nn.softmax(scores, axis=-1)
        top, jidx = jax.lax.top_k(probs, k + 1)
        assert np.array_equal(idx.numpy(), np.asarray(jidx)[..., :k])
        assert float(jnp.min(top[..., k - 1] - top[..., k])) > ROUTE_MARGIN


# ---------------------------------------------------------------- config ---

def test_config_and_program_equal_jax():
    mine, theirs = base.get_arch(ARCH), jax_base.get_arch(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    jcfg, cfg = _configs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tfm.stack_program(mine) == jax_tfm.stack_program(theirs) == [
        ("mla_dense", 1), ("mla_moe", 26)]
    assert tfm.stack_program(cfg) == jax_tfm.stack_program(jcfg) == [
        ("mla_dense", 1), ("mla_moe", 1)]
    assert mine.head_dim == mine.qk_nope_dim + mine.qk_rope_dim == 192
    assert mine.kv_lora_rank + mine.qk_rope_dim == 576


def test_param_counts_on_the_meta_device():
    """(total, active) at full width from shapes alone: 62.8 GB of fp32
    weights are never allocated."""
    got = tfm.param_counts(base.get_arch(ARCH))
    assert got == (15_706_484_224, 2_661_150_208)
    assert got == jax_tfm.param_counts(jax_base.get_arch(ARCH))


def test_moe_capacity_and_shared_width_at_full_size():
    """E 64, top-6, 2 shared experts of 1408: capacity 8 a decode row and
    64 a 512-token group, the shared MLP 2 x 1408 wide (meta device)."""
    full = base.get_arch(ARCH)
    assert moe.capacity(1, full) == 8
    assert moe.capacity(512, full) == 64
    p = moe.moe_init(None, full, device="meta")
    assert p["wg"].shape == (64, 2048, 1408)
    assert p["shared"]["wg"].shape == (2048, 2 * 1408)
    assert p["router"].shape == (2048, 64)


def test_params_round_trip_through_the_jax_layout(lm):
    jcfg, cfg, jparams, params = lm
    assert set(params["layers"][0]) == {"norm1", "attn", "norm2", "mlp"}
    assert set(params["layers"][1]) == {"norm1", "attn", "norm2", "moe"}
    assert set(params["layers"][1]["attn"]) == {"wq", "w_dkv", "kv_norm",
                                                "w_uk", "w_uv", "wo"}
    assert params["layers"][1]["attn"]["w_dkv"].shape == (128, 32 + 16)
    back = convert.lm_params_to_numpy(params, cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))


# ------------------------------------------------------------ the layer ---

def _layer_params(seed=3, lora=32):
    """One MLA layer's JAX and port parameters at the reduced config with
    a latent of `lora`."""
    jcfg, cfg = (dataclasses.replace(c, kv_lora_rank=lora)
                 for c in _configs())
    jp = jax_attn.mla_init(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(9), a.shape),
        jp)  # the latent norm's scale off 1
    return jcfg, cfg, jp, _tensors(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("kernel_attention", [True, False])
def test_mla_forward_matches_jax(kernel_attention):
    """The prefill layer and its cache entry at 1e-5, through the op (V
    zero-padded to nope + rope) and through the blockwise oracle (V at
    its own width)."""
    jcfg, cfg, jp, p = _layer_params()
    x = np.random.default_rng(4).standard_normal((2, 12, 128)).astype(
        np.float32)
    jcos, jsin = jax_rope_table(jnp.arange(12), 16, jcfg.rope_theta)
    cos, sin = rope_table(torch.arange(12), 16, cfg.rope_theta)
    jy, jc = jax.jit(lambda *a: jax_attn.mla_forward(
        JAX_ENGINE, *a, jcfg, n_q_chunks=4, return_cache=True,
        kernel_attention=kernel_attention))(jp, jnp.asarray(x), jcos, jsin)
    with torch.inference_mode():
        y, c = attn.mla_forward(ENGINE, p, torch.from_numpy(x), cos, sin,
                                cfg, n_q_chunks=4, return_cache=True,
                                kernel_attention=kernel_attention)
    assert y.shape == (2, 12, 128)
    assert c["c_kv"].shape == (2, 12, 32) and c["k_rope"].shape == (2, 12, 16)
    assert _relmax(y, jy) <= OP_TOL
    for name in ("c_kv", "k_rope"):
        assert _relmax(c[name], jc[name]) <= OP_TOL


def _decode_case(c, engine=ENGINE, lora=32):
    """One absorbed decode of a C-token chunk (per-sequence starts 5 and
    9) into a 32-row latent cache of width `lora` that holds a seeded
    prefix: (port y, cache), (JAX y, cache)."""
    jcfg, cfg, jp, p = _layer_params(lora=lora)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, c, 128)).astype(np.float32)
    cache = {"c_kv": rng.standard_normal((2, 32, lora)).astype(np.float32),
             "k_rope": rng.standard_normal((2, 32, 16)).astype(np.float32)}
    pos = np.array([5, 9], np.int32)
    positions = pos[:, None] + np.arange(c)
    jcos, jsin = jax_rope_table(jnp.asarray(positions), 16, jcfg.rope_theta)
    cos, sin = rope_table(torch.from_numpy(positions), 16, cfg.rope_theta)
    jy, jc = jax.jit(lambda *a: jax_attn.mla_decode(JAX_ENGINE, *a, jcfg))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(pos), jcos, jsin)
    with torch.inference_mode():
        y, tc = attn.mla_decode(engine, p, torch.from_numpy(x),
                                {k: torch.from_numpy(v.copy())
                                 for k, v in cache.items()},
                                torch.from_numpy(pos), cos, sin, cfg)
    return (y, tc), (jy, jc)


@pytest.mark.parametrize("c", [1, 3, 12])
def test_mla_decode_matches_jax(c):
    """The absorbed decode (W_uk into the query, W_uv after, multi-query
    attention over the latent) and the cache it writes, at 1e-5; a chunk
    of 12 is past `ops.DECODE_MAX_SQ`, so on `cuda` it takes the flash
    forward at the latent's head dim."""
    (y, tc), (jy, jc) = _decode_case(c)
    assert y.shape == (2, c, 128)
    assert _relmax(y, jy) <= OP_TOL
    for name in ("c_kv", "k_rope"):
        assert _relmax(tc[name], jc[name]) <= OP_TOL


class _DefaultScale(ComputeEngine):
    """`eager` with the attention op's scale left at its default,
    1/sqrt(lora + rope): the mistake `mla_decode`'s explicit scale
    avoids."""

    def attention(self, q, k, v, *, causal=True, sm_scale=None,
                  kv_len=None):
        return super().attention(q, k, v, causal=causal, kv_len=kv_len)


def test_decode_scale_is_one_over_sqrt_nope_plus_rope():
    """The absorbed attention's scale is 1/sqrt(nope + rope), as the
    materialised form's.  The reduced config's latent (32) equals nope
    (32), where the op's default 1/sqrt(lora + rope) would be the same
    number, so the layer runs with a latent of 64 (80 wide with rope
    against 48): under the default scale it leaves JAX's by far more than
    the bar."""
    (y, _), (jy, _) = _decode_case(1, lora=64)
    assert _relmax(y, jy) <= OP_TOL
    wrong = _DefaultScale(backend="eager", precision=Precision("fp32_strict"),
                          device=torch.device("cpu"))
    (y, _), (jy, _) = _decode_case(1, wrong, lora=64)
    assert _relmax(y, jy) > 100 * OP_TOL


# ------------------------------------------------- the blockwise oracle ---

@pytest.mark.parametrize("n_q_chunks,kv_chunk", [(1, 1024), (4, 8), (2, 7)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dv", [24, 16])
def test_blockwise_attention_matches_jax(dv, causal, n_q_chunks, kv_chunk):
    """Grouped (KV 2, G 2) queries of width 24 against 20 keys, values of
    width dv (16: Dv != Dh), query chunks and key blocks that split the
    extent raggedly (the last block's start clamped)."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 12, 2, 2, 24)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, dv)).astype(np.float32)
    want = jax_attn.blockwise_attention(
        JAX_ENGINE, *map(jnp.asarray, (q, k, v)), causal=causal,
        n_q_chunks=n_q_chunks, kv_chunk=kv_chunk)
    for backend in ("eager", "ref"):
        got = attn.blockwise_attention(
            make_engine(backend, device="cpu"),
            *map(torch.from_numpy, (q, k, v)), causal=causal,
            n_q_chunks=n_q_chunks, kv_chunk=kv_chunk)
        assert got.shape == (2, 12, 2, 2, dv)
        assert _relmax(got, want) <= OP_TOL


def test_blockwise_attention_refuses_the_cuda_backend_by_name():
    cuda = ComputeEngine(backend="cuda", precision=Precision("fp32_strict"),
                         device=torch.device("cpu"))
    q = torch.zeros(1, 4, 1, 1, 8)
    with pytest.raises(NotImplementedError, match="blockwise_attention"):
        attn.blockwise_attention(cuda, q, q[:, :, :, 0], q[:, :, :, 0],
                                 causal=True)


# ------------------------------------------------------- the einsum specs ---

@pytest.mark.parametrize("spec", list(SPECS))
def test_absorbed_einsums_match_jax(spec):
    """The absorbed decode's two einsums: on `eager` and `ref` through
    `ComputeEngine.einsum`, and in the `cuda` formulation
    (`einsum_as_bmm`: x permuted to (H, B·Q, K), y from (R, H, ·) to (H,
    K, N), the bmm wrapper's plain version on CPU tensors), against JAX's
    `engine.einsum`, fp32 out."""
    xs, ys = SPECS[spec]
    rng = np.random.default_rng(7)
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    want = np.asarray(JAX_ENGINE.einsum(spec, jnp.asarray(x), jnp.asarray(y),
                                        out_dtype=jnp.float32))
    form = backends.bmm_spec(spec)
    assert form[3] == "hbq" + spec[3] and form[4][0] == "h"
    got = backends.einsum_as_bmm(spec, torch.from_numpy(x),
                                 torch.from_numpy(y),
                                 acc_dtype=torch.float32,
                                 out_dtype=torch.float32)
    assert got.shape == want.shape
    assert _relmax(got, want) <= OP_TOL
    for backend in ("eager", "ref"):
        got = make_engine(backend, device="cpu").einsum(
            spec, torch.from_numpy(x), torch.from_numpy(y),
            out_dtype=torch.float32)
        assert _relmax(got, want) <= OP_TOL


def test_bmm_spec_takes_y_in_any_order_and_refuses_the_rest():
    assert backends.bmm_spec("becd,edf->becf")[3:] == ("ebcd", "edf")
    assert backends.bmm_spec("becd,fde->becf")[3:] == ("ebcd", "edf")
    assert backends.bmm_spec("bqhn,rhn->bqhr")[3:] == ("hbqn", "hnr")
    for spec in ("bqhd,bkhd->bhqk", "bqhn,rhn->bqrh", "bqhn,rgn->bqhr",
                 "bqhn,hn->bqh"):
        assert backends.bmm_spec(spec) is None
        with pytest.raises(NotImplementedError, match=re.escape(spec)):
            backends.einsum_as_bmm(spec, torch.zeros(2, 2, 2, 2),
                                   torch.zeros(2, 2, 2),
                                   acc_dtype=torch.float32,
                                   out_dtype=torch.float32)


# ------------------------------------------------------------ the model ---

@pytest.mark.parametrize("kernel_attention", [True, False])
def test_prefill_logits_caches_and_hidden_match_jax(lm, kernel_attention):
    """Routes first, then the prefill's logits and every latent cache
    leaf, and the hidden states, at 1e-4."""
    jcfg, cfg, jparams, params = lm
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    kw = {"n_q_chunks": 1, "kernel_attention": kernel_attention}
    jlogits, jcaches = jax.jit(jax_serve_step.make_prefill_step(
        JAX_ENGINE, jcfg, **kw))(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode(), _Routes() as routes:
        logits, caches = serve_step.make_prefill_step(ENGINE, cfg, **kw)(
            params, {"tokens": torch.from_numpy(tokens).long()})
    _assert_routes_match_jax(routes.calls, cfg.top_k)
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    assert [set(c) for c in caches] == [{"c_kv", "k_rope"}] * 2
    for e in range(2):
        assert caches[e]["c_kv"].shape == (1, 2, 11, 32)
        assert caches[e]["k_rope"].shape == (1, 2, 11, 16)
        for name in ("c_kv", "k_rope"):
            assert _relmax(caches[e][name], jcaches[e][name]) <= TOL
    with torch.inference_mode():
        h, aux = tfm.forward_hidden(ENGINE, cfg, params,
                                    tokens=torch.from_numpy(tokens).long(),
                                    **kw)
    jh, jaux = jax.jit(lambda p, t: jax_tfm.forward_hidden(
        JAX_ENGINE, jcfg, p, tokens=t, **kw))(jparams, jnp.asarray(tokens))
    assert _relmax(h, jh) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


def test_three_token_decode_matches_jax(lm):
    """A 3-token chunk into the latent caches of a 9-token prefill, each
    sequence at its own start (5 and 9) in a 32-row buffer
    (`kvcache.cache_init`, filled by `kvcache.copy_prefill`), routes
    first."""
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    pos = np.array([5, 9], np.int32)
    _, jpre = jax.jit(lambda p, t: jax_tfm.forward_prefill(
        JAX_ENGINE, jcfg, p, tokens=t))(jparams, jnp.asarray(prompt))
    jcaches = [{k: c[k].at[:, :, :9].set(p[k]) for k in c}
               for c, p in zip(jax_kvcache.cache_init(jcfg, 2, 32), jpre)]
    jlogits, jnew = jax.jit(jax_serve_step.make_decode_step(
        JAX_ENGINE, jcfg))(jparams, jcaches, jnp.asarray(chunk),
                           jnp.asarray(pos))
    caches = kvcache.cache_init(cfg, 2, 32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in caches] == [
        {"c_kv": (1, 2, 32, 32), "k_rope": (1, 2, 32, 16)}] * 2
    with torch.inference_mode():
        _, pre = tfm.forward_prefill(ENGINE, cfg, params,
                                     tokens=torch.from_numpy(prompt).long())
        kvcache.copy_prefill(cfg, caches, pre, 9)
        with _Routes() as routes:
            logits, caches = serve_step.make_decode_step(ENGINE, cfg)(
                params, caches, torch.from_numpy(chunk).long(),
                torch.from_numpy(pos))
    _assert_routes_match_jax(routes.calls, cfg.top_k)
    assert logits.shape == (2, 3, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    for e in range(2):
        for name in ("c_kv", "k_rope"):
            assert _relmax(caches[e][name], jnew[e][name]) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_with_aux_matches_jax(lm, remat):
    """The loss with the load-balance term (aux_coef 0.5, far above the
    bar), routes first, and its gradient with respect to the router and
    the absorbed W_uk, on `eager`."""
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jax_tfm.loss_fn(JAX_ENGINE, jcfg, p, jbatch, aux_coef=0.5,
                               remat=remat, ce_chunk=8)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    jce = jax.jit(lambda p: jax_tfm.loss_fn(JAX_ENGINE, jcfg, p, jbatch,
                                            aux_coef=0.0, remat=False,
                                            ce_chunk=8))(jparams)
    assert abs(float(jval) - float(jce)) > 100 * TOL * abs(float(jval))
    leaves = [params["layers"][1]["moe"]["router"],
              params["layers"][0]["attn"]["w_uk"]]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with _Routes() as routes:
            val = tfm.loss_fn(ENGINE, cfg, params,
                              {k: torch.from_numpy(v).long()
                               for k, v in batch.items()},
                              aux_coef=0.5, remat=remat, ce_chunk=8)
        grads = torch.autograd.grad(val, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    _assert_routes_match_jax(routes.calls, cfg.top_k)
    assert abs(val.item() - float(jval)) <= TOL * abs(float(jval))
    assert _relmax(grads[0], jgrads["stacks"][1]["moe"]["router"][0]) <= TOL
    assert _relmax(grads[1], jgrads["stacks"][0]["attn"]["w_uk"][0]) <= TOL


def _stream(cls, cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(2, 8))
                                           ).tolist(),
                max_new=int(rng.integers(2, 5)))
            for i in range(n)]


def test_slot_engine_streams_equal_the_jax_engine(lm):
    """Four requests through two slots on the replay route, so two are
    served in reused slots: the port's greedy streams are the JAX slot
    engine's, and a reused slot's stream is the request's served alone."""
    jcfg, cfg, jparams, params = lm
    jreqs = _stream(JaxRequest, jcfg, 4)
    JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=2,
                     max_len=24).run(jreqs)
    reqs = _stream(Request, cfg, 4)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=24)
    slot.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == r.max_new for r in reqs)
    st = slot.stats()
    assert st["requests"]["completed"] == 4
    # a step's plan: two absorbed einsums a layer, three expert GEMMs a
    # MoE layer
    assert st["op_counts"][("eager", "einsum")] == 2 * cfg.n_layers + 3 * (
        cfg.n_layers - cfg.first_dense_layers)
    for r in _stream(Request, cfg, 4)[2:]:
        ServingEngine(cfg, params, engine=ENGINE, slots=2,
                      max_len=24).run([r])
        assert r.out == reqs[r.rid].out


def test_paged_engine_refuses_the_mla_stack_by_name(lm):
    _, cfg, _, params = lm
    with pytest.raises(NotImplementedError, match="mla_dense"):
        PagedServingEngine(cfg, params, engine=ENGINE, kv_blocks=8,
                           block_size=8, max_len=32, chunk=4)


# ------------------------------ the attention kernels at MLA's head dims ---

@pytest.mark.parametrize("kv_len", [None, [48, 20]])
def test_forward_at_head_dim_192_matches_the_jax_pallas_kernel(kv_len):
    """The prefill's attention: 4 / 4 heads of 192, 16 queries against
    48 keys, causal, through `ops.attention` (the forward wrapper's plain
    version on CPU tensors), against the JAX flash kernel in interpret
    mode, the scale 1/sqrt(192)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 16, 4, 192)).astype(np.float32)
    k = rng.standard_normal((2, 48, 4, 192)).astype(np.float32)
    v = rng.standard_normal((2, 48, 4, 192)).astype(np.float32)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jax_ops.attention(*map(jnp.asarray, (q, k, v)),
                             None if kvl is None else jnp.asarray(kvl),
                             causal=True, interpret=True)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)),
                        None if kvl is None else torch.from_numpy(kvl),
                        causal=True)
    assert got.shape == (2, 16, 4, 192)
    assert _relmax(got, want) <= OP_TOL
    assert fa.plan_for(2, 16, 4, 4, 192) == fa.PLANS[2]


def _latent_operands(seed, sq, skv=48):
    """The absorbed attention's operands at deepseek's widths: q (2, sq,
    16, 576), one latent kv-head kv (2, skv, 1, 576) and V = [c_kv, 0]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 16, 576)).astype(np.float32)
    kv = rng.standard_normal((2, skv, 1, 576)).astype(np.float32)
    v = np.concatenate([kv[..., :512], np.zeros_like(kv[..., 512:])], -1)
    return q, kv, v


@pytest.mark.parametrize("sq", [1, 12])
@pytest.mark.parametrize("case", ["causal_kv_len", "not_causal",
                                  "return_lse"])
def test_forward_at_head_dim_576_matches_the_jax_pallas_kernel(case, sq):
    """The absorbed attention where the split-KV kernel does not take it
    (a slot step against a cache under 256 rows, a chunk of more than 8
    tokens): G = 16 query heads over one latent kv-head of 576, V = [c_kv,
    0], the scale 1/sqrt(192), Sq 1 and 12 against 48 keys, through
    `ops.attention` (the forward wrapper's plain version on CPU tensors)
    against the JAX flash kernel in interpret mode; causal with a kv_len
    of 0, not causal, and the lse launch against JAX's lse forward."""
    q, kv, v = _latent_operands(11, sq)
    scale = 1.0 / 192 ** 0.5
    causal = case != "not_causal"
    kvl = np.array({"causal_kv_len": [48, 0], "not_causal": [48, 20],
                    "return_lse": [48, 20]}[case], np.int32)
    tq, tkv, tv, tkvl = map(torch.from_numpy, (q, kv, v, kvl))
    if case == "return_lse":
        qs = (q * np.float32(scale)).astype(np.float32)
        jo, jlse = flash_attention_with_lse(
            *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (qs, kv, v)),
            causal=True, sm_scale=1.0, bq=sq, bk=16,
            kv_len=jnp.asarray(kvl), interpret=True)
        o, lse = fa.flash_attention_fwd(torch.from_numpy(qs), tkv, tv, tkvl,
                                        causal=True, return_lse=True)
        assert lse.shape == (2, 16, sq) and lse.dtype == torch.float32
        assert _relmax(lse, jlse) <= OP_TOL
        assert _relmax(o, np.asarray(jo).transpose(0, 2, 1, 3)) <= OP_TOL
        return
    want = jax_ops.attention(*map(jnp.asarray, (q, kv, v, kvl)),
                             sm_scale=scale, causal=causal, interpret=True)
    got = ops.attention(tq, tkv, tv, tkvl, scale, causal=causal)
    assert got.shape == (2, sq, 16, 576)
    assert float(got[..., 512:].abs().max()) == 0.0
    assert _relmax(got, want) <= OP_TOL
    if case == "causal_kv_len":
        assert bool((got[1] == 0).all())
    assert fa.plan_for(2, sq, 16, 1, 576) == fa.PLANS[2]


@pytest.mark.parametrize("sq", [1, 4])
def test_decode_at_head_dim_576_matches_the_jax_pallas_kernel(sq):
    """The absorbed decode's attention: G = 16 query heads over one
    latent kv-head of 576, values [c_kv, 0], the scale 1/sqrt(192),
    against 384 rows, through `ops.attention_decode` (the decode wrapper's
    plain partials and merge on CPU tensors) against the JAX split-KV
    kernel in interpret mode."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, sq, 16, 576)).astype(np.float32)
    kv = rng.standard_normal((2, 384, 1, 576)).astype(np.float32)
    v = np.concatenate([kv[..., :512], np.zeros_like(kv[..., 512:])], -1)
    kvl = np.array([384, 130], np.int32)
    scale = 1.0 / 192 ** 0.5
    want = jax_ops.attention_decode(
        *map(jnp.asarray, (q, kv, v, kvl)), sm_scale=scale, causal=sq > 1,
        bk_split=128, n_splits=3, interpret=True)
    got = ops.attention_decode(*map(torch.from_numpy, (q, kv, v, kvl)),
                               scale, causal=sq > 1)
    assert got.shape == (2, sq, 16, 576)
    assert float(got[..., 512:].abs().max()) == 0.0
    assert _relmax(got, want) <= OP_TOL


def test_plans_at_mla_head_dims_fit_in_shared_memory():
    """At 192 and at 576 the forward admits the 32-lane plan alone (the
    8-lane plans' fp32 blocks are past MAX_SMEM; at 576 K and V stream
    through 32-key half tiles), picks it at every shape and refuses the
    others by name; the plans of every earlier head dim are as they were;
    every decode block at 576 (K and V in 32-key half tiles) fits, fp32
    and bf16, as at every other head dim."""
    for d in (192, 576):
        assert fa.plans_at(d) == (fa.PLANS[2],)
        for plan in fa.PLANS:
            need = fa.fwd_smem_bytes(d, plan)
            assert (need <= fa.MAX_SMEM) == (plan in fa.plans_at(d)), plan
    assert fa.fwd_smem_bytes(576, fa.PLANS[2]) == 167_040
    assert fa.fwd_smem_bytes(576, fa.PLANS[2], torch.bfloat16) == 84_096
    assert {d: fa.plans_at(d) for d in (32, 64, 80, 112, 128)} == {
        32: fa.PLANS, 64: fa.PLANS, 80: fa.PLANS[:2], 112: fa.PLANS[:2],
        128: fa.PLANS}
    for d in fa.FWD_HEAD_DIMS:
        for plan in fa.plans_at(d):
            for dt in (torch.float32, torch.bfloat16):
                assert fa.fwd_smem_bytes(d, plan, dt) <= fa.MAX_SMEM
    for shape in ((1, 1, 16, 16), (2, 512, 16, 16), (1, 64, 16, 16),
                  (8, 4096, 16, 16)):
        assert fa.plan_for(*shape, 192) == fa.PLANS[2]
    for shape in ((4, 1, 16, 1), (2, 64, 16, 1), (1, 1, 16, 1),
                  (8, 4096, 16, 1), (64, 512, 16, 1)):
        assert fa.plan_for(*shape, 576) == fa.PLANS[2]
    for d in (192, 576):
        q = torch.zeros(1, 4, 2, d)
        for plan in fa.PLANS[:2]:
            with pytest.raises(ValueError, match=f"head dim {d}"):
                fa.flash_attention_fwd(q, q, q, plan=plan)
    for d in fd.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            assert fd.smem_bytes(d, dt) <= fd.MAX_SMEM
    assert fd.smem_bytes(576) == 189_696


@pytest.mark.parametrize("kernel", ["forward_576", "dq_192", "dkv_192",
                                    "autograd_192"])
def test_kernels_refuse_the_head_dims_they_lack(kernel):
    """The forward at 576 refuses the plans its block does not fit (the
    8-lane ones; the case keeps the id it had when the forward refused
    576 whole), and dQ / dK / dV at 576, a head dim that is never trained,
    are not instantiated (the `*_192` cases keep the ids they had when the
    backward refused MLA's 192, which it now takes; `dq_192` also holds
    the dQ kernel's refusal of its 64-row plan at 192): each refuses by
    name, on the CPU as on the card."""
    rng = np.random.default_rng(10)
    q576 = torch.from_numpy(rng.standard_normal((2, 4, 16, 576)).astype(
        np.float32))
    k576 = torch.from_numpy(rng.standard_normal((2, 40, 1, 576)).astype(
        np.float32))
    q, do = (torch.from_numpy(rng.standard_normal((2, 4, 4, 192)).astype(
        np.float32)) for _ in range(2))
    k = torch.from_numpy(rng.standard_normal((2, 16, 4, 192)).astype(
        np.float32))
    lse = delta = torch.zeros(2, 4, 4)
    lse16 = torch.zeros(2, 16, 4)
    calls = {
        "forward_576": (lambda: fa.flash_attention_fwd(
            q576, k576, k576, plan=fa.PLANS[0]), 576),
        "dq_192": (lambda: fa.flash_attention_bwd_dq(
            q576, q576, q576, q576, lse16, lse16), 576),
        "dkv_192": (lambda: fa.flash_attention_bwd_dkv(
            q576, q576, q576, q576, lse16, lse16), 576),
        "autograd_192": (lambda: fa.FlashAttention.apply(
            q576.requires_grad_(), k576, k576, None, True), 576)}
    call, d = calls[kernel]
    with pytest.raises(ValueError, match=f"head dim {d}"):
        call()
    if kernel == "forward_576":
        with pytest.raises(ValueError, match="head dim 576"):
            fa.flash_attention_fwd(q576, k576, k576, plan=fa.PLANS[1])
    if kernel == "dq_192":
        with pytest.raises(ValueError, match="head dim 192"):
            fa.flash_attention_bwd_dq(q, k, k, do, lse, delta,
                                      plan=fa.BWD_PLANS[0])


def test_backward_plans_at_192_fit_in_shared_memory():
    """The backward at MLA's 192 admits the 16-row dQ plan alone (the
    64-row plan's fp32 block needs 319,488 bytes, past MAX_SMEM), picks it
    at every shape, including those where 128 and below take 64 rows;
    every admitted dQ plan fits at every backward head dim, fp32 and bf16,
    and the rule refuses exactly the plans whose fp32 block does not
    fit."""
    assert fa.bwd_plans_at(192) == (fa.BWD_PLANS[1],)
    assert fa.bwd_smem_bytes(192, fa.BWD_PLANS[0]) == 319_488
    assert fa.bwd_smem_bytes(192, fa.BWD_PLANS[1]) == 231_936
    for d in fa.BWD_HEAD_DIMS:
        for plan in fa.BWD_PLANS:
            fits = fa.bwd_smem_bytes(d, plan) <= fa.MAX_SMEM
            assert fits == (plan in fa.bwd_plans_at(d)), (d, plan)
            for dt in (torch.float32, torch.bfloat16):
                if plan in fa.bwd_plans_at(d):
                    assert fa.bwd_smem_bytes(d, plan, dt) <= fa.MAX_SMEM
    assert fa.bwd_plans_at(128) == fa.BWD_PLANS
    for shape in ((1, 16, 16, 16), (2, 512, 16, 16), (8, 4096, 16, 16)):
        assert fa.bwd_plan_for(*shape, 192) == fa.BWD_PLANS[1]
    assert fa.bwd_plan_for(8, 4096, 16, 16, 128) == fa.BWD_PLANS[0]
