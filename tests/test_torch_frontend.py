"""The port's modality frontends against the JAX package, on the CPU.

`reduced(internvl2-2b)` (vision: 2 layers, d 128, 4 heads over 2 kv-heads
of 32, 8 patch embeddings of 64) and `reduced(hubert-xlarge)` (audio:
encoder-only, layer norm, gelu MLP, 4 MHA heads of 32, frames of 64), the
JAX parameters carried across with `convert.lm_params_from_jax`, inputs
from a numpy seed.  The port runs on the `eager` backend, JAX on `xla`.
Bars: 1e-5 max-relative for the projector alone (two fp32 programs, one
or two GEMMs after a layer norm) and for attention at head dim 80; 1e-4
on logits, caches and the loss (two layers of GEMMs, RoPE tables from two
libraries).  Also: the inputs layout against JAX's ``input_specs``, the
engines refusing an encoder-only config and serving a vision config's
text-only streams as the JAX engines do, and the attention kernels' head
dims (the forward at 80 under every plan that admits it; dQ, dK / dV and
`FlashAttention` at 80 against jax.grad of the JAX attention oracle; the
decode kernel refusing 80).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.kernels.ref import flash_attention_ref as jax_attention_ref
from repro.models import frontend as jax_fe
from repro.models import transformer as jax_tfm
from repro.models.common import lm_head_logits as jax_lm_head_logits
from repro.serve import kvcache as jax_kvcache
from repro.serve import serve_step as jax_serve_step
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.serve.scheduler import PagedServingEngine as JaxPagedEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import ComputeEngine, make_engine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import frontend as fe
from repro_torch.models import transformer as tfm
from repro_torch.serve import kvcache, serve_step
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine

torch.set_num_threads(1)

TOL = 1e-4
FRONTEND_TOL = 1e-5
ATTN_TOL = 1e-5
NAMES = ("internvl2-2b", "hubert-xlarge")
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
MARGIN = 1e-3  # the JAX top-2 margin every served token must clear
PAGED = dict(kv_blocks=8, block_size=8, max_len=32, chunk=4,
             batch_buckets=(1, 2, 4))


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _configs(name):
    return (jax_base.reduced(jax_base.get_arch(name)),
            base.reduced(base.get_arch(name)))


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(jcfg, cfg, jparams, params) of a reduced frontend config, with
    random projector biases and layer-norm parameters (the init's zeros
    and ones would leave them untested)."""
    jcfg, cfg = _configs(request.param)
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    jparams["frontend"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape).astype(np.float32)), jparams["frontend"])
    params = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, params


def _inputs(cfg, seed, b, s):
    """Prefill inputs of `b` sequences of `s` positions as numpy arrays in
    the JAX layout (for a vision config s counts the patches too)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)}
    t = cfg.frontend_tokens
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - t)).astype(
                np.int32),
            "patch_embeds": rng.standard_normal(
                (b, t, cfg.frontend_dim)).astype(np.float32)}


def _jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _torch(inputs):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in inputs.items()}


# ---------------------------------------------------------------- configs ---

@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_the_jax_configs(name):
    mine, theirs = base.get_arch(name), jax_base.get_arch(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (dataclasses.asdict(base.reduced(mine))
            == dataclasses.asdict(jax_base.reduced(theirs)))
    assert mine.vocab_padded == theirs.vocab_padded
    assert tfm.stack_program(mine) == [("dense", mine.n_layers)]
    assert (tfm.stack_program(mine) == jax_tfm.stack_program(theirs))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", NAMES)
def test_input_tensors_follow_the_jax_input_specs(name, kind):
    cfg = base.get_arch(name)
    shape = base.ShapeConfig("cell", 300, 2, kind)
    specs = jax_base.input_specs(jax_base.get_arch(name),
                                 jax_base.ShapeConfig("cell", 300, 2, kind))
    got = base.input_tensors(cfg, shape,
                             generator=torch.Generator().manual_seed(3))
    again = base.input_tensors(cfg, shape,
                               generator=torch.Generator().manual_seed(3))
    assert set(got) == set(specs)
    for key, spec in specs.items():
        assert tuple(got[key].shape) == tuple(spec.shape), key
        floating = jnp.issubdtype(spec.dtype, jnp.floating)
        assert got[key].dtype == (torch.float32 if floating
                                  else torch.int64), key
        assert torch.equal(got[key], again[key]), key
    for key in ("tokens", "labels", "token"):
        if key in got:
            assert 0 <= int(got[key].min()) <= int(got[key].max()) \
                < cfg.vocab_size


def test_params_round_trip_through_the_jax_layout(model):
    jcfg, cfg, jparams, params = model
    back = convert.lm_params_to_numpy(params, cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    assert "frontend" in params and "embed" in params  # audio keeps embed
    fresh = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jparams))
        == jax.tree_util.tree_structure(convert.lm_params_to_numpy(fresh, cfg)))


# --------------------------------------------------------------- frontend ---

def test_frontend_apply_matches_jax(model):
    jcfg, cfg, jparams, params = model
    feats = np.random.default_rng(2).standard_normal(
        (2, 7, cfg.frontend_dim)).astype(np.float32)
    want = jax_fe.frontend_apply(JAX_ENGINE, jparams["frontend"],
                                 jnp.asarray(feats), jcfg)
    with torch.inference_mode():
        got = fe.frontend_apply(ENGINE, params["frontend"],
                                torch.from_numpy(feats), cfg)
    assert got.shape == (2, 7, cfg.d_model)
    assert _relmax(got, want) <= FRONTEND_TOL


def test_frontend_init_follows_the_jax_shapes(model):
    jcfg, cfg, jparams, _ = model
    got = fe.frontend_init(torch.Generator().manual_seed(0), cfg)
    want = jax_fe.frontend_init(jax.random.PRNGKey(0), jcfg)
    assert (jax.tree_util.tree_map(np.shape, jax.tree_util.tree_map(
        lambda t: t.numpy(), got)) == jax.tree_util.tree_map(np.shape, want))
    assert fe.frontend_init(torch.Generator(), base.reduced(
        base.get_arch("qwen2-0.5b"))) == {}


# ------------------------------------------------------------- the models ---

def test_prefill_or_forward_logits_match_jax(model, monkeypatch):
    """A vision config's prefill (logits and caches, the patch rows first)
    through `make_prefill_step(inputs)`; an audio config's
    `make_forward_step` logits, its attention dispatched with
    causal=False."""
    jcfg, cfg, jparams, params = model
    inputs = _inputs(cfg, 4, 2, 17)
    seen = []
    eng = make_engine("eager", device="cpu")
    attention = ComputeEngine.attention
    monkeypatch.setattr(ComputeEngine, "attention", lambda *a, **kw: (
        seen.append(kw["causal"]), attention(*a, **kw))[1])
    with torch.inference_mode():
        if cfg.is_encoder:
            want = jax_serve_step.make_forward_step(JAX_ENGINE, jcfg)(
                jparams, _jax(inputs))
            got = serve_step.make_forward_step(eng, cfg)(params,
                                                         _torch(inputs))
        else:
            want, jcaches = jax_serve_step.make_prefill_step(
                JAX_ENGINE, jcfg)(jparams, _jax(inputs))
            got, caches = serve_step.make_prefill_step(eng, cfg)(
                params, _torch(inputs))
            for name in ("k", "v"):
                assert caches[0][name].shape == (
                    cfg.n_layers, 2, 17, cfg.n_kv_heads, cfg.head_dim)
                assert _relmax(caches[0][name], jcaches[0][name]) <= TOL
    assert got.shape == (2, 1, cfg.vocab_padded)
    assert _relmax(got, want) <= TOL
    assert seen == [cfg.causal] * cfg.n_layers
    assert cfg.causal == (cfg.frontend == "vision")


def test_vision_three_token_decode_matches_jax():
    """A 3-token chunk into caches filled by a vision prefill (8 patch
    rows and 9 text rows), each sequence at its own start, through
    `make_decode_step`: text tokens only, as JAX decodes."""
    jcfg, cfg = _configs("internvl2-2b")
    jparams = jax_tfm.init_params(jax.random.PRNGKey(5), jcfg)
    params = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    inputs = _inputs(cfg, 6, 2, 17)
    chunk = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                              (2, 3)).astype(np.int32)
    pos = np.array([13, 17], np.int32)
    _, jpre = jax_serve_step.make_prefill_step(JAX_ENGINE, jcfg)(
        jparams, _jax(inputs))
    jcaches = [{k: c[k].at[:, :, :17].set(p[k]) for k in c}
               for c, p in zip(jax_kvcache.cache_init(jcfg, 2, 32), jpre)]
    jlogits, jnew = jax_serve_step.make_decode_step(JAX_ENGINE, jcfg)(
        jparams, jcaches, jnp.asarray(chunk), jnp.asarray(pos))
    caches = kvcache.cache_init(cfg, 2, 32)
    with torch.inference_mode():
        _, pre = serve_step.make_prefill_step(ENGINE, cfg)(params,
                                                           _torch(inputs))
        for name in ("k", "v"):
            caches[0][name][:, :, :17] = pre[0][name]
        logits, caches = serve_step.make_decode_step(ENGINE, cfg)(
            params, caches, torch.from_numpy(chunk).long(),
            torch.from_numpy(pos))
    assert logits.shape == (2, 3, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    for name in ("k", "v"):
        assert _relmax(caches[0][name], jnew[0][name]) <= TOL


def test_loss_matches_jax(model):
    jcfg, cfg, jparams, params = model
    inputs = _inputs(cfg, 8, 2, 16)
    inputs["labels"] = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = jax_tfm.loss_fn(JAX_ENGINE, jcfg, jparams, _jax(inputs),
                           remat=False, ce_chunk=8)
    got = tfm.loss_fn(ENGINE, cfg, params, _torch(inputs), ce_chunk=8)
    assert got.shape == ()
    assert _relmax(got.detach(), want) <= TOL


def test_hidden_states_match_jax(model):
    """`forward_hidden` and `forward_prefill` take patch_embeds= / frames=
    as JAX does; the vision stack sees the patches before the text."""
    jcfg, cfg, jparams, params = model
    inputs = _inputs(cfg, 10, 1, 12)
    jh, _ = jax_tfm.forward_hidden(JAX_ENGINE, jcfg, jparams,
                                   **_jax(inputs), remat=False)
    with torch.inference_mode():
        h, aux = tfm.forward_hidden(ENGINE, cfg, params, **_torch(inputs))
        hp, _ = tfm.forward_prefill(ENGINE, cfg, params, **_torch(inputs),
                                    collect_caches=False)
    assert h.shape == (1, 12, cfg.d_model) and float(aux) == 0.0
    assert torch.equal(h, hp)
    assert _relmax(h, jh) <= TOL


# ----------------------------------------------------------- the engines ---

@pytest.mark.parametrize("engine_cls", [ServingEngine, PagedServingEngine])
def test_engines_refuse_an_encoder_only_config(engine_cls):
    cfg = base.reduced(base.get_arch("hubert-xlarge"))
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"hubert-xlarge-reduced.*"
                                         r"encoder-only.*make_forward_step"):
        engine_cls(cfg, params, engine=ENGINE)


def _stream(cls, cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size, int(
        rng.integers(2, 12))).tolist(), max_new=int(rng.integers(2, 7)))
        for i in range(n)]


@pytest.fixture(scope="module")
def vision_streams():
    """The JAX slot and paged engines' greedy streams for reduced
    internvl2-2b's text-only requests, each emitted token's JAX top-2
    margin above MARGIN (teacher-forced on the text-only stack)."""
    jcfg, cfg = _configs("internvl2-2b")
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jslot = _stream(JaxRequest, jcfg, 6)
    JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=2,
                     max_len=32).run(jslot)
    jpaged = _stream(JaxRequest, jcfg, 6)
    JaxPagedEngine(jcfg, jparams, engine=JAX_ENGINE, **PAGED).run(jpaged)
    text = dataclasses.replace(jcfg, frontend="none")
    w = jax_tfm.head_weight(jparams, jcfg)
    for r in jpaged:
        h, _ = jax_tfm.forward_hidden(
            JAX_ENGINE, text, jparams,
            tokens=jnp.asarray([r.prompt + r.out[:-1]], jnp.int32))
        rows = np.asarray(jax_lm_head_logits(
            JAX_ENGINE, h, w, vocab_real=jcfg.vocab_size))[0][
                len(r.prompt) - 1:]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        assert [int(t) for t in rows.argmax(-1)] == r.out
        assert float((top2[:, 1] - top2[:, 0]).min()) > MARGIN
    return cfg, params, [r.out for r in jslot], [r.out for r in jpaged]


@pytest.mark.parametrize("paged", [False, True])
def test_engines_serve_vision_text_streams_as_the_jax_engines(
        vision_streams, paged):
    cfg, params, jslot, jpaged = vision_streams
    reqs = _stream(Request, cfg, 6)
    if paged:
        PagedServingEngine(cfg, params, engine=ENGINE, **PAGED).run(reqs)
        assert [r.out for r in reqs] == jpaged
    else:
        ServingEngine(cfg, params, engine=ENGINE, slots=2,
                      max_len=32).run(reqs)
        assert [r.out for r in reqs] == jslot


# ------------------------------------------------- attention, head dim 80 ---

@pytest.mark.parametrize("kv_len", [None, [40, 0]])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_at_head_dim_80_matches_the_jax_oracle(causal, kv_len):
    """The forward wrapper's plain version (a CPU tensor) and the `cuda`
    formulation `ops.attention` at head dim 80 against JAX's oracle."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 24, 4, 80)).astype(np.float32)
    k = rng.standard_normal((2, 50, 4, 80)).astype(np.float32)
    v = rng.standard_normal((2, 50, 4, 80)).astype(np.float32)
    kvl = None if kv_len is None else np.array(kv_len, np.int32)
    want = np.asarray(jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=None if kvl is None else jnp.asarray(kvl)))
    tkvl = None if kvl is None else torch.from_numpy(kvl)
    qs = ops.scale_queries(torch.from_numpy(q))
    before = fa.launch_counts()
    got = {"wrapper": fa.flash_attention_fwd(qs, torch.from_numpy(k),
                                             torch.from_numpy(v), tkvl,
                                             causal=causal),
           "ops": ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tkvl, causal=causal)}
    assert fa.launch_counts() == before
    for name, out in got.items():
        assert out.shape == (2, 24, 4, 80)
        assert _relmax(out, want) <= ATTN_TOL, name
    if kvl is not None:
        assert bool((got["wrapper"][1] == 0).all())


PLAN_SHAPES = [(b, sq, h, kv) for b in (1, 4, 16) for sq in (1, 8, 64, 500)
               for h, kv in ((16, 16), (16, 8), (4, 4))]


def test_plan_for_at_head_dim_80_picks_an_instantiated_plan():
    assert fa.plans_at(80) == (fa.PLANS[0], fa.PLANS[1])
    assert all(fa.plans_at(d) == fa.PLANS for d in (32, 64, 128))
    for shape in PLAN_SHAPES:
        got = fa.plan_for(*shape, 80)
        assert got in fa.plans_at(80), shape
        if fa.plan_for(*shape) in fa.plans_at(80):
            assert got == fa.plan_for(*shape), shape
    assert fa.plan_for(4, 500, 16, 16, 80) == fa.PLANS[1]  # hubert 4 x 500


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_plan_at_head_dim_80_runs_the_plain_version(dtype):
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((2, 9, 4, 80), (2, 20, 2, 80),
                                    (2, 20, 2, 80)))
    kvl = torch.tensor([20, 7], dtype=torch.int32)
    want = fa.flash_attention_plain(q, k, v, kvl)
    for plan in fa.plans_at(80):
        assert torch.equal(fa.flash_attention_fwd(q, k, v, kvl, plan=plan),
                           want)
    with pytest.raises(ValueError, match="head dim 80"):
        fa.flash_attention_fwd(q, k, v, kvl, plan=fa.PLANS[2])
    with pytest.raises(ValueError, match="head dim 96"):
        fa.flash_attention_fwd(*(torch.zeros(1, 4, 2, 96),) * 3)


@pytest.mark.parametrize("kernel", ["dq", "dkv", "decode", "partials",
                                    "autograd"])
def test_head_dim_80_in_the_backward_and_decode_kernels(kernel):
    """hubert-xlarge trains at head dim 80: dQ, dK / dV (their plain
    versions, which the wrappers run on a CPU tensor) and `FlashAttention`
    equal jax.grad of the JAX attention oracle, not causal, at 1e-5; the
    split-KV decode kernel, not instantiated at 80, refuses it by name."""
    rng = np.random.default_rng(13)
    q, w = (rng.standard_normal((2, 4, 4, 80)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((2, 256, 2, 80)).astype(np.float32)
            for _ in range(2))
    q = q / 80 ** 0.5
    kvl = np.array([256, 100], np.int32)
    tq, tk, tv, tw, tkvl = map(torch.from_numpy, (q, k, v, w, kvl))
    if kernel in ("decode", "partials"):
        with pytest.raises(ValueError, match="head dim 80"):
            (fd.flash_decode if kernel == "decode" else
             fd.flash_decode_partials)(tq, tk, tv, tkvl, causal=True,
                                       n_splits=4, span=64)
        return

    def jloss(q, k, v):
        return jnp.sum(jax_attention_ref(q, k, v, causal=False, sm_scale=1.0,
                                         kv_len=jnp.asarray(kvl)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    if kernel == "autograd":
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        o = fa.FlashAttention.apply(*leaves, tkvl, False)
        got = torch.autograd.grad((o * tw).sum(), leaves)
    else:
        o, lse = fa.flash_attention_fwd(tq, tk, tv, tkvl, causal=False,
                                        return_lse=True)
        delta = (tw * o).sum(-1).transpose(1, 2).contiguous()
        args = (tq, tk, tv, tw, lse, delta, tkvl)
        if kernel == "dq":
            got = [fa.flash_attention_bwd_dq(*args, causal=False)]
            want = want[:1]
        else:
            got = fa.flash_attention_bwd_dkv(*args, causal=False)
            want = want[1:]
    for g, x in zip(got, want):
        assert g.shape == x.shape
        assert _relmax(g.detach(), x) <= ATTN_TOL
