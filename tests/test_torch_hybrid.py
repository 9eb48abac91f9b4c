"""The port's hybrid (zamba2) program against the JAX package, on the CPU.

`reduced(zamba2-7b)` (4 mamba layers in 2 super entries of 2, d 128, 8
SSD heads of 32, state 16, chunk 32; the shared block's 4 MHA heads of
32 and gelu MLP of 256) and its five-layer variant, whose program ends in
a one-layer mamba tail, with the JAX parameters carried across by
`convert.lm_params_from_jax` (the mixers' dt bias, A and D moved off
their init).  The port runs on the `eager` backend, JAX on `xla`, inputs
from numpy seeds.  Bars: 1e-4 max-relative on hidden states, caches,
logits and the loss (a few layers of fp32 GEMMs and scans, RoPE tables
from two libraries); 1e-5 for attention alone at head dim 112.  Also: the
config, the full-size parameter count, the layouts of the parameters and
the caches, the slot engine's streams (a reused slot is zeroed, where the
JAX engine carries its state), the refusals (the paged engine, an empty
prompt, dQ / dK / dV at 112), and the attention wrappers at zamba2's head
dim 112 (the flash forward under the plans that admit it, the split-KV
decode at G = 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.kernels.flash_decode import combine as jax_combine
from repro.kernels.ref import flash_attention_ref as jax_attention_ref
from repro.models import transformer as jax_tfm
from repro.models.common import lm_head_logits as jax_lm_head_logits
from repro.serve import kvcache as jax_kvcache
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import backends, make_engine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.serve import frontend as fe
from repro_torch.serve import kvcache
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine
from repro_torch.tree import flatten, unflatten_like

torch.set_num_threads(1)

TOL = 1e-4
ATTN_TOL = 1e-5
MARGIN = 1e-3  # the JAX top-2 margin every compared token must clear
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
ARCH = "zamba2-7b"
VARIANTS = ("reduced", "tail")


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _configs(variant):
    """(JAX config, port config): `reduced`, or its five-layer variant
    with a one-layer mamba tail."""
    jcfg = jax_base.reduced(jax_base.get_arch(ARCH))
    cfg = base.reduced(base.get_arch(ARCH))
    if variant == "tail":
        jcfg = dataclasses.replace(jcfg, n_layers=5)
        cfg = dataclasses.replace(cfg, n_layers=5)
    return jcfg, cfg


_MODELS: dict = {}


def _model(variant):
    """(jcfg, cfg, JAX params, port params), built once per variant: the
    JAX init with every mixer's dt bias, A and D moved off their init, so
    every parameter reaches the output."""
    if variant not in _MODELS:
        jcfg, cfg = _configs(variant)
        jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(1)
        for stack in jparams["stacks"]:
            mixer = stack["mixer"]
            for name, scale in (("dt_bias", 0.5), ("A_log", 0.3),
                                ("D", 0.5)):
                mixer[name] = mixer[name] + jnp.asarray(rng.standard_normal(
                    mixer[name].shape).astype(np.float32) * scale)
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        _MODELS[variant] = (jcfg, cfg, jparams,
                            convert.lm_params_from_jax(tree, cfg))
    return _MODELS[variant]


@pytest.fixture(scope="module", params=VARIANTS)
def model(request):
    return _model(request.param)


def _leaves(tree) -> dict:
    """{path: array} of a cache or parameter tree of either package."""
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _assert_caches_close(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert _relmax(got[name], want[name]) <= tol, name


# --------------------------------------------------------------- config ---

def test_config_equals_the_jax_config():
    mine, theirs = base.get_arch(ARCH), jax_base.get_arch(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (dataclasses.asdict(base.reduced(mine))
            == dataclasses.asdict(jax_base.reduced(theirs)))
    assert (mine.ssm_nheads, mine.ssm_d_inner, mine.vocab_padded) == (
        112, 7168, 32000)


@pytest.mark.parametrize("variant", VARIANTS)
def test_stack_program_is_the_jax_program(variant):
    jcfg, cfg = _configs(variant)
    assert tfm.stack_program(cfg) == jax_tfm.stack_program(jcfg)
    assert tfm.stack_program(cfg) == (
        [("zamba_super", 2)] if variant == "reduced"
        else [("zamba_super", 2), ("mamba", 1)])
    full = base.get_arch(ARCH)
    assert tfm.stack_program(full) == [("zamba_super", 13), ("mamba", 3)]


def test_param_counts_at_full_size_match_jax():
    """The meta device allocates nothing: 6.6e9 parameters, 26.5 GB in
    fp32, counted from shapes alone, the shared block included."""
    cfg = base.get_arch(ARCH)
    assert tfm.param_counts(cfg) == (6_623_604_944, 6_623_604_944)
    assert tfm.param_counts(cfg) == jax_tfm.param_counts(
        jax_base.get_arch(ARCH))
    shared = tfm.init_params(cfg, generator=None, device="meta")["shared"]
    assert sum(t.numel() for t in flatten(shared).values()) == (
        2 * 3584 + 2 * 3584 * 3584 + 2 * 3584 + 4 * 3584 * 3584
        + 2 * 3584 * 14336 + 3584 * 3584)


# ------------------------------------------------------ parameter layout ---

def test_params_round_trip_through_the_jax_layout(model):
    jcfg, cfg, jparams, params = model
    back = convert.lm_params_to_numpy(params, cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    assert len(params["layers"]) == cfg.n_layers
    # super entry i's layer j is layer i * attn_every + j, row-major
    want = np.asarray(jparams["stacks"][0]["mixer"]["wx"][1, 0])
    assert np.array_equal(params["layers"][2]["mixer"]["wx"].numpy(), want)
    assert set(params["shared"]) == {"norm_in", "win", "norm1", "attn",
                                     "norm2", "mlp", "wout"}
    assert params["shared"]["win"].shape == (256, 128)


def test_port_init_has_the_jax_tree_shapes(model):
    jcfg, cfg, jparams, _ = model
    mine = convert.lm_params_to_numpy(tfm.init_params(
        cfg, generator=torch.Generator().manual_seed(0)), cfg)
    want = jax.tree_util.tree_map(lambda t: t.shape, jparams)
    assert jax.tree_util.tree_map(lambda t: t.shape, mine) == want


def test_cache_init_matches_the_jax_cache_struct(model):
    jcfg, cfg, _, _ = model
    want = jax_kvcache.cache_struct(jcfg, 3, 16)
    got = kvcache.cache_init(cfg, 3, 16)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, want)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, got))
    assert ({k: v.shape for k, v in flatten(got).items()}
            == {k: tuple(v.shape) for k, v in flatten(want).items()})
    assert all(bool((t == 0).all()) for t in flatten(got).values())


# ------------------------------------------------------- prefill / decode ---

def test_prefill_and_decode_match_jax(model):
    """forward_prefill's hidden states and every cache leaf (the super
    entries' mamba rows, the shared block's K / V, the tail), then three
    one-token decode steps from those caches, each step's hidden states
    and caches, at 1e-4."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jh, jcaches = jax_tfm.forward_prefill(JAX_ENGINE, jcfg, jparams,
                                          tokens=jnp.asarray(tokens))
    with torch.inference_mode():
        h, caches = tfm.forward_prefill(
            ENGINE, cfg, params, tokens=torch.from_numpy(tokens).long())
    assert h.shape == (2, 37, cfg.d_model)
    assert _relmax(h, jh) <= TOL
    _assert_caches_close(caches, jcaches, TOL)
    # the decode steps run against caches with room for them
    s_max = 37 + 3
    jbuf = jax_kvcache.cache_init(jcfg, 2, s_max)
    buf = kvcache.cache_init(cfg, 2, s_max)
    for e, (kind, _) in enumerate(tfm.stack_program(cfg)):
        if kind == "zamba_super":
            jbuf[e] = {"mamba": jcaches[e]["mamba"], "shared": {
                k: jbuf[e]["shared"][k].at[:, :, :37].set(
                    jcaches[e]["shared"][k]) for k in ("k", "v")}}
        else:
            jbuf[e] = jcaches[e]
    kvcache.copy_prefill(cfg, buf, caches, 37)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = 37 + i
        jh, jbuf = jax_tfm.decode_hidden(JAX_ENGINE, jcfg, jparams, jbuf,
                                         jnp.asarray(tok),
                                         jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            h, buf = tfm.decode_hidden(ENGINE, cfg, params, buf,
                                       torch.from_numpy(tok).long(), pos)
        assert h.shape == (2, 1, cfg.d_model)
        assert _relmax(h, jh) <= TOL, i
        _assert_caches_close(buf, jbuf, TOL)


def test_hybrid_decode_takes_one_token(model):
    _, cfg, _, params = model
    caches = kvcache.cache_init(cfg, 1, 8)
    with pytest.raises(ValueError, match="one token"):
        tfm.decode_hidden(ENGINE, cfg, params, caches,
                          torch.zeros(1, 2, dtype=torch.long), 0)


def test_loss_matches_jax(model):
    """loss_fn on `eager` (remat on, each super entry recomputed as one
    piece) against JAX `xla`, and a finite gradient of every parameter,
    the shared block's included."""
    jcfg, cfg, jparams, params = model
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jloss = jax_tfm.loss_fn(JAX_ENGINE, jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            ce_chunk=16)
    leaves = {k: t.clone().requires_grad_()
              for k, t in flatten(params).items()}
    loss = tfm.loss_fn(ENGINE, cfg, unflatten_like(leaves, params),
                       {k: torch.from_numpy(v).long()
                        for k, v in batch.items()}, ce_chunk=16)
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["shared.win"].abs().sum()) > 0


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
def served():
    """Four requests of the tail variant through two slots on the JAX
    engine, and each request alone on a fresh JAX engine (every token's
    JAX margin above MARGIN)."""
    jcfg, cfg, jparams, params = _model("tail")
    shared = _stream(JaxRequest, jcfg, 4, seed=0)
    JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=2,
                     max_len=32).run(shared)
    alone = []
    for r in _stream(JaxRequest, jcfg, 4, seed=0):
        JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=1,
                         max_len=32).run([r])
        assert min(_margins(jcfg, jparams, r)) > MARGIN
        alone.append(r.out)
    return cfg, params, [r.out for r in shared], alone


def test_slot_engine_equals_the_jax_engine_on_first_use_slots(served):
    """The two first-use slots give the JAX engine's streams, though the
    port prefills each prompt (the SSD op and the flash forward) where the
    JAX engine replays it token by token."""
    cfg, params, shared, _ = served
    reqs = _stream(Request, cfg, 4, seed=0)
    ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32).run(reqs)
    assert [r.out for r in reqs[:2]] == shared[:2]


def test_slot_engine_resets_a_reused_slot(served):
    """Every request's stream on the port equals its stream alone: at
    admission a slot's mamba rows (the super entries' and the tail's) are
    zeroed and the prompt is prefilled into them and into the shared
    block's KV rows; every prompt takes one SSD dispatch per mamba layer
    and one attention dispatch per super entry."""
    cfg, params, _, alone = served
    reqs = _stream(Request, cfg, 4, seed=0)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32)
    snap = backends.dispatch_counts()
    slot.run(reqs)
    assert [r.out for r in reqs] == alone
    counts = backends.counts_since(snap)
    assert counts[("eager", "ssd")] == 4 * cfg.n_layers
    n_super = tfm.stack_program(cfg)[0][1]
    steps = slot.stats()["steps"]
    assert counts[("eager", "attention")] == (4 + steps) * n_super
    assert slot.stats()["requests"]["completed"] == 4


def test_a_reused_slot_matches_the_request_alone_where_jax_does_not():
    """The reference's quirk, pinned for the hybrid: the JAX slot engine
    resets only the position at admission, so a request after another in
    the same slot starts from the old conv tails and SSM states.  The
    port's stream there equals the request alone."""
    jcfg, cfg, jparams, params = _model("tail")
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


def test_admission_zeroes_only_the_slots_mamba_rows(model):
    """A one-token prompt has nothing to prefill: admission zeroes the
    slot's mamba rows of every entry and leaves the other slot's rows and
    the shared KV rows alone."""
    _, cfg, _, params = model
    eng = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=8)
    for t in flatten(eng.caches).values():
        t.fill_(1.0)
    eng.submit(Request(rid=0, prompt=[1], max_new=1))
    eng._admit()
    for name, t in flatten(eng.caches).items():
        if ".shared." in name:
            assert bool((t == 1.0).all()), name
            continue
        # a super entry's mamba leaves are (n, attn_every, B, ...)
        axis = 2 if ".mamba." in name else 1
        assert bool((t.select(axis, 0) == 0).all()), name
        assert bool((t.select(axis, 1) == 1.0).all()), name


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b", ARCH])
def test_slot_rows_and_copy_prefill_walk_the_cache_layout(arch):
    """`kvcache.slot_rows` gives views of one slot (every mamba leaf's
    rows, and the first rows of every K / V leaf when asked) and
    `copy_prefill` fills a buffer from a prefill's caches: mamba leaves
    whole, K / V rows [0, n), every other row left zero."""
    cfg = dataclasses.replace(base.reduced(base.get_arch(arch)), n_layers=5)
    n, gen = 3, torch.Generator().manual_seed(4)
    pre = kvcache.cache_init(cfg, 2, n)
    for t in flatten(pre).values():
        t.copy_(torch.randn(t.shape, generator=gen))
    buf = kvcache.cache_init(cfg, 2, 8)
    kvcache.copy_prefill(cfg, buf, pre, n)
    pre, got = flatten(pre), flatten(buf)
    assert set(pre) == set(got)
    for name, t in got.items():
        kv = name.endswith((".k", ".v"))
        # the K / V row axis follows the layer axis and the batch
        want = t[:, :, :n] if kv else t
        assert torch.equal(want, pre[name]), name
        if kv:
            assert bool((t[:, :, n:] == 0).all()), name
    mamba = kvcache.slot_rows(cfg, buf, 1)
    both = kvcache.slot_rows(cfg, buf, 1, n)
    assert len(both) == len(mamba) + sum(
        name.endswith((".k", ".v")) for name in got)
    for view in both:
        view.fill_(7.0)
    for name, t in got.items():
        axis = 2 if ".mamba." in name else 1
        assert bool((t.select(axis, 1)[..., :n, :, :] == 7.0).all()
                    if name.endswith((".k", ".v"))
                    else (t.select(axis, 1) == 7.0).all()), name
        assert bool((t.select(axis, 0) != 7.0).all()), name


def test_slot_engine_refuses_an_empty_prompt(model):
    _, cfg, _, params = model
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=1, max_len=16)
    with pytest.raises(fe.RejectedRequest, match="empty prompt"):
        slot.submit(Request(rid=0, prompt=[], max_new=4))
    assert not slot.pending and slot.stats()["requests"]["rejected"] == 1


def test_paged_engine_refuses_the_hybrid_naming_its_program(model):
    _, cfg, _, params = model
    with pytest.raises(NotImplementedError, match="zamba_super"):
        PagedServingEngine(cfg, params, engine=ENGINE, kv_blocks=8,
                           block_size=8, max_len=32, chunk=4)


# ------------------------------------------ the attention at head dim 112 ---

def _attention_operands(b, sq, skv, h, kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, 112)).astype(dtype) / 112 ** 0.5
    k = rng.standard_normal((b, skv, kv, 112)).astype(dtype)
    v = rng.standard_normal((b, skv, kv, 112)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("kv_len", [None, [20, 7]])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_at_head_dim_112_matches_the_jax_oracle(causal, kv_len):
    """The flash forward's wrapper (its plain version on a CPU tensor)
    at zamba2's MHA (G = 1) under every plan `plans_at(112)` admits."""
    q, k, v = _attention_operands(2, 9, 20, 4, 4, seed=21)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = np.asarray(jax_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=1.0,
        kv_len=None if kvl is None else jnp.asarray(kvl)))
    tkvl = None if kvl is None else torch.from_numpy(kvl)
    for plan in fa.plans_at(112):
        got = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), tkvl,
                                     causal=causal, plan=plan)
        assert got.shape == (2, 9, 4, 112)
        assert _relmax(got, want) <= ATTN_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_decode_at_head_dim_112_matches_the_jax_oracle(causal):
    """The split-KV decode's wrappers at G = 1 (zamba2's shared block)
    against 528 rows, the spans of `ops.decode_splits`: the merged output
    against JAX's attention oracle, the partials merged by JAX's
    `combine`, and `ops.attention_decode` on a CPU tensor."""
    q, k, v = _attention_operands(2, 1, 528, 4, 4, seed=22)
    kvl = np.asarray([513, 300], np.int32)
    n_splits, span = ops.decode_splits(528, 4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, o_part, lse_part = fd.flash_decode(
        tq, tk, tv, torch.from_numpy(kvl), causal=causal,
        n_splits=n_splits, span=span)
    want = np.asarray(jax_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=1.0,
        kv_len=jnp.asarray(kvl)))
    assert out.shape == (2, 1, 4, 112) and o_part.shape[-1] == 112
    assert _relmax(out, want) <= ATTN_TOL
    merged = np.asarray(jax_combine(jnp.asarray(o_part.numpy()),
                                    jnp.asarray(lse_part.numpy())))
    assert _relmax(out.transpose(1, 2), merged) <= ATTN_TOL
    op = ops.attention_decode(tq * 112 ** 0.5, tk, tv,
                              torch.from_numpy(kvl), causal=causal)
    assert _relmax(op, want) <= ATTN_TOL


def test_plans_at_head_dim_112_leave_the_32_lane_plan_out():
    assert fa.plans_at(112) == (fa.PLANS[0], fa.PLANS[1])
    for b, sq, h, kv in ((1, 1, 32, 32), (1, 64, 32, 32), (2, 512, 32, 32),
                         (1, 8, 4, 4), (8, 4096, 32, 32)):
        assert fa.plan_for(b, sq, h, kv, 112) in fa.plans_at(112)
    assert fa.plan_for(2, 512, 32, 32, 112) == fa.PLANS[1]
    q = torch.zeros(1, 4, 2, 112)
    with pytest.raises(ValueError, match="head dim 112"):
        fa.flash_attention_fwd(q, q, q, plan=fa.PLANS[2])


@pytest.mark.parametrize("kernel", ["dq", "dkv", "autograd"])
def test_backward_kernels_at_head_dim_112_match_jax_grad(kernel):
    """zamba2 trains its shared block at head dim 112: dQ, dK / dV (their
    plain versions, which the wrappers run on a CPU tensor) and
    `FlashAttention`, causal, G = 1, against jax.grad of the JAX attention
    oracle at 1e-5."""
    rng = np.random.default_rng(23)
    q, w = (rng.standard_normal((2, 4, 4, 112)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((2, 16, 4, 112)).astype(np.float32)
            for _ in range(2))
    q = q / 112 ** 0.5
    kvl = np.array([16, 9], np.int32)

    def jloss(q, k, v):
        return jnp.sum(jax_attention_ref(q, k, v, causal=True, sm_scale=1.0,
                                         kv_len=jnp.asarray(kvl)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    tkvl = torch.from_numpy(kvl)
    if kernel == "autograd":
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        o = fa.FlashAttention.apply(*leaves, tkvl, True)
        got = torch.autograd.grad((o * tw).sum(), leaves)
    else:
        o, lse = fa.flash_attention_fwd(tq, tk, tv, tkvl, return_lse=True)
        delta = (tw * o).sum(-1).transpose(1, 2).contiguous()
        args = (tq, tk, tv, tw, lse, delta, tkvl)
        if kernel == "dq":
            got, want = [fa.flash_attention_bwd_dq(*args)], want[:1]
        else:
            got, want = fa.flash_attention_bwd_dkv(*args), want[1:]
    for g, x in zip(got, want):
        assert g.shape == x.shape
        assert _relmax(g.detach(), x) <= ATTN_TOL
