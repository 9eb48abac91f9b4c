"""The port's MoE family against the JAX package, on the CPU.

`reduced(llama4-scout-17b-a16e)` (2 layers, d 128, 4 heads over 2
kv-heads of 32, 4 experts of d_ff 128, top-1, one shared expert, untied
head), the JAX parameters carried across with `convert.lm_params_from_jax`,
inputs from a numpy seed.  The port runs on `eager` (and `ref`), JAX on
`xla`.  Bars: 1e-5 max-relative for one op or one MoE layer in fp32,
1e-4 for the two-layer model (logits, caches, a 3-token decode, the
loss), 5e-2 under `mixed` (the bf16 bar).  The MoE layer's routing is
compared first: a route that flips between the packages would move every
later number, so each case asserts equal expert ids before the values.
The `cuda` einsum's formulation (`backends.einsum_as_bmm`: a permutation
and the bmm kernel) runs here through the kernel wrapper's plain version.
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
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tfm
from repro.serve import kvcache as jax_kvcache
from repro.serve import serve_step as jax_serve_step
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import ComputeEngine, backends, make_engine
from repro_torch.core.precision import Precision
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.serve import kvcache, kvpool, serve_step
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine

torch.set_num_threads(1)

ARCH = "llama4-scout-17b-a16e"
OP_TOL = 1e-5
TOL = 1e-4
MIXED_TOL = 5e-2  # the bf16 bar of tests/test_grad_conformance.py
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
SPECS = {"becd,edf->becf": ((2, 4, 8, 16), (4, 16, 24)),
         "becf,efd->becd": ((2, 4, 8, 24), (4, 24, 16))}


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_base.reduced(jax_base.get_arch(ARCH))
    cfg = base.reduced(base.get_arch(ARCH))
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.lm_params_from_jax(tree, cfg)


def test_config_equals_the_jax_config():
    mine, theirs = base.get_arch(ARCH), jax_base.get_arch(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (dataclasses.asdict(base.reduced(mine))
            == dataclasses.asdict(jax_base.reduced(theirs)))
    assert tfm.stack_program(mine) == jax_tfm.stack_program(theirs) == [
        ("gqa_moe", 48)]


def test_mla_config_raises_by_name():
    """A MoE config with a latent runs the MLA program (no dense first
    layer here), which the paged KV pool refuses naming it."""
    cfg = dataclasses.replace(base.get_arch(ARCH), kv_lora_rank=32)
    assert tfm.stack_program(cfg) == [("mla_moe", 48)]
    with pytest.raises(NotImplementedError, match="mla_moe"):
        kvpool.PagedKVCache(cfg, n_blocks=2, block_size=4, device="meta")


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
def test_capacity_equals_jax(factor):
    cfg = dataclasses.replace(base.reduced(base.get_arch(ARCH)),
                              capacity_factor=factor)
    jcfg = dataclasses.replace(jax_base.reduced(jax_base.get_arch(ARCH)),
                               capacity_factor=factor)
    for s in (1, 3, 8, 11, 64, 128, 1000):
        for k in (1, 2):
            a = moe.capacity(s, dataclasses.replace(cfg, top_k=k))
            b = jax_moe.capacity(s, dataclasses.replace(jcfg, top_k=k))
            assert a == b and a % 8 == 0 and a >= 8, (s, k, a, b)
    full = base.get_arch(ARCH)
    assert moe.capacity(1, full) == 8                 # a decode row
    assert moe.capacity(128, full) == 16              # a 128-token prompt


def _einsum_operands(spec, seed=0):
    xs, ys = SPECS[spec]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            (rng.standard_normal(ys) / np.sqrt(ys[1])).astype(np.float32))


@pytest.mark.parametrize("policy", ["fp32_strict", "mixed"])
@pytest.mark.parametrize("backend", ["ref", "eager"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_einsum_matches_jax(spec, backend, policy):
    """`ComputeEngine.einsum` against JAX's, with the MoE layer's dtypes
    (acc_dtype = out_dtype = the policy's reduce dtype) and with the
    defaults (fp32 accumulation, the compute dtype out).  This jax's CPU
    dot takes no bf16 x bf16 = fp32, so under `mixed` the defaults are
    held against JAX's fp32 einsum of the bf16-rounded operands (exact
    products, fp32 sums), cast to bf16."""
    x, y = _einsum_operands(spec)
    eng = make_engine(backend, policy, device="cpu")
    jeng = jax_make_engine("xla", policy)
    rdt, jrdt = eng.precision.reduce_dtype, jeng.precision.reduce_dtype
    tol = OP_TOL if policy == "fp32_strict" else MIXED_TOL
    snap = backends.dispatch_counts()
    for kw, jkw in (({}, {}), ({"acc_dtype": rdt, "out_dtype": rdt},
                               {"acc_dtype": jrdt, "out_dtype": jrdt})):
        got = eng.einsum(spec, torch.from_numpy(x), torch.from_numpy(y), **kw)
        if policy == "mixed" and not kw:
            bf = [jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                  for a in (x, y)]
            want = JAX_ENGINE.einsum(spec, *bf).astype(jnp.bfloat16)
        else:
            want = jeng.einsum(spec, jnp.asarray(x), jnp.asarray(y), **jkw)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert got.shape == want.shape
        assert _relmax(got.float(), np.asarray(want, np.float32)) <= tol
    assert backends.counts_since(snap) == {(backend, "einsum"): 2}


@pytest.mark.parametrize("spec", list(SPECS))
def test_cuda_einsum_formulation_matches_jax(spec):
    """The `cuda` backend's formulation: permute to (E, B·C, K), the bmm
    kernel's wrapper (its plain version on CPU tensors), permute back."""
    x, y = _einsum_operands(spec, seed=1)
    want = np.asarray(JAX_ENGINE.einsum(spec, jnp.asarray(x), jnp.asarray(y),
                                        out_dtype=jnp.float32))
    got = backends.einsum_as_bmm(spec, torch.from_numpy(x),
                                 torch.from_numpy(y),
                                 acc_dtype=torch.float32,
                                 out_dtype=torch.float32)
    assert got.shape == want.shape
    assert _relmax(got, want) <= OP_TOL


def test_cuda_einsum_refuses_other_specs_and_cpu_tensors():
    assert backends.bmm_spec("becd,edf->becf")[3] == "ebcd"
    assert backends.bmm_spec("becf,efd->becd")[3] == "ebcf"
    # y's indices may come in any order: (F, D, E) is permuted to (E, D, F)
    assert backends.bmm_spec("becd,fde->becf")[3:] == ("ebcd", "edf")
    for spec in ("bqhd,bkhd->bhqk", "bcd,df->bcf", "becd,edf->bcef",
                 "becd,gdf->becf"):
        assert backends.bmm_spec(spec) is None
        with pytest.raises(NotImplementedError, match=re.escape(spec)):
            backends.einsum_as_bmm(spec, torch.zeros(2, 2, 2, 2),
                                   torch.zeros(2, 2, 2),
                                   acc_dtype=torch.float32,
                                   out_dtype=torch.float32)
    cuda = ComputeEngine(backend="cuda", precision=Precision("fp32_strict"),
                         device=torch.device("cpu"))
    x, y = _einsum_operands("becd,edf->becf")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.einsum("becd,edf->becf", torch.from_numpy(x),
                    torch.from_numpy(y))


MOE_CASES = {
    "base": {},
    "drops": {"capacity_factor": 0.5},
    "top_k_2": {"top_k": 2},
    "no_shared": {"n_shared_experts": 0},
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_jax(case):
    """`moe_forward` (y and the aux loss) on reduced llama4 against JAX at
    1e-5, routes first.  "drops": 64 tokens a group over 4 experts at
    capacity 8, so tokens overflow (counted, and the count must be > 0)."""
    over = MOE_CASES[case]
    jcfg = dataclasses.replace(jax_base.reduced(jax_base.get_arch(ARCH)),
                               **over)
    cfg = dataclasses.replace(base.reduced(base.get_arch(ARCH)), **over)
    jp = jax_moe.moe_init(jax.random.PRNGKey(3), jcfg)
    p = _tensors(jax.tree_util.tree_map(np.asarray, jp))
    assert ("shared" in p) == bool(cfg.n_shared_experts)
    s = 64 if case == "drops" else 12
    x = np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    jy, jaux = jax_moe.moe_forward(JAX_ENGINE, jp, jnp.asarray(x), jcfg)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        y, aux = moe.moe_forward(ENGINE, p, xt, cfg)
        _, idx, _ = moe.route(ENGINE, p, xt, cfg)
    jscores = JAX_ENGINE.matmul(jnp.asarray(x), jp["router"],
                                out_dtype=jnp.float32)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jscores, axis=-1), cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    dropped = int((moe.positions(idx, cfg.n_routed_experts)
                   >= moe.capacity(s, cfg)).sum())
    if case == "drops":
        assert dropped > 0
    assert y.shape == (2, s, cfg.d_model) and aux.dtype == torch.float32
    assert _relmax(y, jy) <= OP_TOL
    assert abs(float(aux) - float(jaux)) <= OP_TOL * abs(float(jaux))


def test_params_round_trip_through_the_jax_layout(lm):
    """The stacked (n, E, D, F) expert leaves become per-layer (E, D, F),
    the router (D, E), the shared expert an MLP dict, and back."""
    jcfg, cfg, jparams, params = lm
    lp = params["layers"][1]["moe"]
    assert lp["wg"].shape == lp["wu"].shape == (4, 128, 128)
    assert lp["wd"].shape == (4, 128, 128)
    assert lp["router"].shape == (128, 4)
    assert set(lp["shared"]) == {"wg", "wu", "wd"}
    assert np.array_equal(lp["wg"].numpy(),
                          np.asarray(jparams["stacks"][0]["moe"]["wg"][1]))
    back = convert.lm_params_to_numpy(params, cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))


def test_prefill_logits_caches_and_hidden_match_jax(lm):
    jcfg, cfg, jparams, params = lm
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jlogits, jcaches = jax_serve_step.make_prefill_step(JAX_ENGINE, jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, caches = serve_step.make_prefill_step(ENGINE, cfg)(
            params, {"tokens": torch.from_numpy(tokens).long()})
        h, aux = tfm.forward_hidden(ENGINE, cfg, params,
                                    tokens=torch.from_numpy(tokens).long())
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    for name in ("k", "v"):
        assert caches[0][name].shape == (2, 2, 11, 2, 32)
        assert _relmax(caches[0][name], jcaches[0][name]) <= TOL
    jh, jaux = jax_tfm.forward_hidden(JAX_ENGINE, jcfg, jparams,
                                      tokens=jnp.asarray(tokens))
    assert _relmax(h, jh) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


def test_three_token_decode_matches_jax(lm):
    """A 3-token chunk into caches filled by a prefill, each sequence at
    its own start (5 and 9) in a 32-row buffer: each row's three new
    tokens are one routing group, as in JAX."""
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    pos = np.array([5, 9], np.int32)
    _, jpre = jax_tfm.forward_prefill(JAX_ENGINE, jcfg, jparams,
                                      tokens=jnp.asarray(prompt))
    jcaches = [{k: c[k].at[:, :, :9].set(p[k]) for k in c}
               for c, p in zip(jax_kvcache.cache_init(jcfg, 2, 32), jpre)]
    jlogits, jnew = jax_serve_step.make_decode_step(JAX_ENGINE, jcfg)(
        jparams, jcaches, jnp.asarray(chunk), jnp.asarray(pos))
    caches = kvcache.cache_init(cfg, 2, 32)
    assert [set(c) for c in caches] == [{"k", "v"}]
    with torch.inference_mode():
        _, pre = tfm.forward_prefill(ENGINE, cfg, params,
                                     tokens=torch.from_numpy(prompt).long())
        for name in ("k", "v"):
            caches[0][name][:, :, :9] = pre[0][name]
        logits, caches = serve_step.make_decode_step(ENGINE, cfg)(
            params, caches, torch.from_numpy(chunk).long(),
            torch.from_numpy(pos))
    assert logits.shape == (2, 3, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    for name in ("k", "v"):
        assert _relmax(caches[0][name], jnew[0][name]) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_with_aux_matches_jax(lm, remat):
    """The loss with the MoE load-balance term (aux_coef 0.5, so the term
    is far above the bar), and its gradient with respect to the router
    and an expert weight, which the aux term and the routed weights
    reach."""
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jax_tfm.loss_fn(JAX_ENGINE, jcfg, p, jbatch, aux_coef=0.5,
                               remat=remat, ce_chunk=8)

    jval, jgrads = jax.value_and_grad(jloss)(jparams)
    jce = jax_tfm.loss_fn(JAX_ENGINE, jcfg, jparams, jbatch, aux_coef=0.0,
                          remat=False, ce_chunk=8)
    assert abs(float(jval) - float(jce)) > 100 * TOL * abs(float(jval))
    leaves = [params["layers"][1]["moe"]["router"],
              params["layers"][0]["moe"]["wd"]]
    for t in leaves:
        t.requires_grad_(True)
    try:
        val = tfm.loss_fn(ENGINE, cfg, params,
                          {k: torch.from_numpy(v).long()
                           for k, v in batch.items()},
                          aux_coef=0.5, remat=remat, ce_chunk=8)
        grads = torch.autograd.grad(val, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert abs(val.item() - float(jval)) <= TOL * abs(float(jval))
    jmoe = jgrads["stacks"][0]["moe"]
    assert _relmax(grads[0], jmoe["router"][1]) <= TOL
    assert _relmax(grads[1], jmoe["wd"][0]) <= TOL


def test_mixed_policy_matches_jax(lm):
    """`mixed` on `eager` against JAX `xla` `mixed`: prefill logits and the
    loss with its aux term, at the bf16 bar."""
    jcfg, cfg, jparams, params = lm
    jeng = jax_make_engine("xla", "mixed")
    eng = make_engine("eager", "mixed", device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlogits, _ = jax_serve_step.make_prefill_step(jeng, jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jloss = jax_tfm.loss_fn(jeng, jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=False, ce_chunk=8)
    with torch.inference_mode():
        logits, pre = serve_step.make_prefill_step(eng, cfg)(
            params, {"tokens": torch.from_numpy(tokens).long()})
        loss = tfm.loss_fn(eng, cfg, params,
                           {k: torch.from_numpy(v).long()
                            for k, v in batch.items()},
                           remat=False, ce_chunk=8)
    assert logits.dtype == torch.float32
    assert pre[0]["k"].dtype == torch.bfloat16
    assert _relmax(logits, jlogits) <= MIXED_TOL
    assert abs(loss.item() - float(jloss)) <= MIXED_TOL * abs(float(jloss))


def _stream(cls, cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(2, 10))
                                           ).tolist(),
                max_new=int(rng.integers(2, 6)))
            for i in range(n)]


def test_slot_engine_streams_equal_the_jax_engine(lm):
    """Five requests through two slots (so slots are reused), on the dense
    replay route: the port's greedy streams are the JAX slot engine's."""
    jcfg, cfg, jparams, params = lm
    jreqs = _stream(JaxRequest, jcfg, 5)
    JaxServingEngine(jcfg, jparams, engine=JAX_ENGINE, slots=2,
                     max_len=32).run(jreqs)
    reqs = _stream(Request, cfg, 5)
    slot = ServingEngine(cfg, params, engine=ENGINE, slots=2, max_len=32)
    slot.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == r.max_new for r in reqs)
    st = slot.stats()
    assert st["requests"]["completed"] == 5
    assert st["op_counts"][("eager", "einsum")] == 3 * cfg.n_layers


def test_paged_engine_refuses_the_moe_stack_by_name(lm):
    _, cfg, _, params = lm
    with pytest.raises(NotImplementedError, match="gqa_moe"):
        PagedServingEngine(cfg, params, engine=ENGINE, kv_blocks=8,
                           block_size=8, max_len=32, chunk=4)


@pytest.mark.parametrize("name", base.ARCH_IDS)
def test_param_counts_equal_jax(name):
    """(total, active) at full width, from shapes on the meta device: the
    full llama4 (108e9 parameters, 431 GB in fp32) is never allocated."""
    got = tfm.param_counts(base.get_arch(name))
    assert got == jax_tfm.param_counts(jax_base.get_arch(name))
    if name == ARCH:
        assert got[0] > 1e11 and got[1] < got[0]
