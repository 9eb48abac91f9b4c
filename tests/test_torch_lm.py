"""The port's dense GQA LM against the JAX package, on the CPU.

`reduced(qwen2-0.5b)` (2 layers, d 128, 4 heads over 2 kv-heads, head dim
32, QKV bias, tied embeddings), the JAX parameters carried across with
`convert.lm_params_from_jax`, tokens from a numpy seed.  The port runs on
the `eager` backend; JAX on `xla`.  Bar: 1e-4 max-relative on logits,
hidden states and caches (two fp32 programs, two layers of GEMMs, RoPE
tables computed by two libraries); under `mixed` (bf16 operands and
activations, fp32 accumulation and master parameters) 5e-2 on prefill
logits, a decode step and the loss, the bf16 bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tfm
from repro.serve import kvcache as jax_kvcache
from repro.serve import serve_step as jax_serve_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import make_engine
from repro_torch.kernels import gemm, ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.serve import kvcache, serve_step

torch.set_num_threads(1)

TOL = 1e-4
MIXED_TOL = 5e-2  # the bf16 bar of tests/test_grad_conformance.py
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    cfg = base.reduced(base.get_arch("qwen2-0.5b"))
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    # non-zero QKV biases, so the bias epilogue is exercised
    rng = np.random.default_rng(1)
    stack = jparams["stacks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        stack[name] = jnp.asarray(
            rng.standard_normal(stack[name].shape).astype(np.float32) * 0.1)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.lm_params_from_jax(tree, cfg)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen2-1.5b", "qwen2.5-3b",
                                  "phi3-medium-14b"])
def test_configs_equal_the_jax_configs(name):
    mine, theirs = base.get_arch(name), jax_base.get_arch(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (dataclasses.asdict(base.reduced(mine))
            == dataclasses.asdict(jax_base.reduced(theirs)))
    assert mine.vocab_padded == theirs.vocab_padded


def test_other_families_raise_naming_the_family():
    cfg = dataclasses.replace(base.get_arch("qwen2-0.5b"), family="moe")
    with pytest.raises(NotImplementedError, match="'moe'"):
        tfm.stack_program(cfg)
    with pytest.raises(ValueError, match="unported"):
        base.get_arch("zamba2-7b")


def test_params_round_trip_through_the_jax_layout(lm):
    jcfg, cfg, jparams, params = lm
    back = convert.lm_params_to_numpy(params)
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    assert len(params["layers"]) == cfg.n_layers
    assert params["layers"][1]["attn"]["wq"].shape == (128, 4 * 32)


def test_tied_head_is_laid_out_once(lm):
    """The tied head is the embedding table itself, read transposed in
    place: no second copy, nothing to keep in step with the table."""
    _, cfg, _, params = lm
    table = params["embed"]["tokens"]
    w = tfm.head_weight(params, cfg)
    assert w.shape == (cfg.d_model, cfg.vocab_padded)
    assert w.data_ptr() == table.data_ptr() and gemm.is_transposed(w)
    assert set(params) == {"embed", "final_norm", "layers"}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, cfg.d_model)).astype(np.float32))
    got, want = ops.matmul(x, w), ops.matmul(x, w.contiguous())
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(x, table[::2].t())       # neither layout: refused
    e = table.clone().requires_grad_()      # training reads it in place too
    (de,) = torch.autograd.grad(ops.matmul(x, e.t()).sum(), (e,))
    assert de.shape == table.shape
    assert torch.allclose(de, x.sum(0).expand_as(table), atol=1e-5)


def test_forward_prefill_logits_and_caches_match_jax(lm):
    jcfg, cfg, jparams, params = lm
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jlogits, jcaches = jax_serve_step.make_prefill_step(JAX_ENGINE, jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, caches = serve_step.make_prefill_step(ENGINE, cfg)(
            params, torch.from_numpy(tokens).long())
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    for name in ("k", "v"):
        assert caches[0][name].shape == (2, 2, 11, 2, 32)
        assert _relmax(caches[0][name], jcaches[0][name]) <= TOL
    jh, _ = jax_tfm.forward_prefill(JAX_ENGINE, jcfg, jparams,
                                    tokens=jnp.asarray(tokens))
    with torch.inference_mode():
        h = tfm.forward_hidden(ENGINE, cfg, params,
                               tokens=torch.from_numpy(tokens).long())
    assert _relmax(h, jh) <= TOL


def test_three_token_decode_with_per_sequence_positions_matches_jax(lm):
    """A 3-token chunk into caches filled by a prefill, each sequence at
    its own start (5 and 9) in a 32-row buffer."""
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    pos = np.array([5, 9], np.int32)
    _, jpre = jax_tfm.forward_prefill(JAX_ENGINE, jcfg, jparams,
                                      tokens=jnp.asarray(prompt))
    jcaches = jax_kvcache.cache_init(jcfg, 2, 32)
    jcaches = [{k: c[k].at[:, :, :9].set(p[k]) for k in c}
               for c, p in zip(jcaches, jpre)]
    jh, jnew = jax_tfm.decode_hidden(JAX_ENGINE, jcfg, jparams, jcaches,
                                     jnp.asarray(chunk), jnp.asarray(pos))
    jlogits = jax_serve_step.make_decode_step(JAX_ENGINE, jcfg)(
        jparams, jcaches, jnp.asarray(chunk), jnp.asarray(pos))[0]

    caches = kvcache.cache_init(cfg, 2, 32)
    with torch.inference_mode():
        _, pre = tfm.forward_prefill(ENGINE, cfg, params,
                                     tokens=torch.from_numpy(prompt).long())
        for name in ("k", "v"):
            caches[0][name][:, :, :9] = pre[0][name]
        step = serve_step.make_decode_step(ENGINE, cfg)
        logits, caches = step(params, caches, torch.from_numpy(chunk).long(),
                              torch.from_numpy(pos))
    assert logits.shape == (2, 3, cfg.vocab_padded)
    assert _relmax(logits, jlogits) <= TOL
    for name in ("k", "v"):
        assert _relmax(caches[0][name], jnew[0][name]) <= TOL


@pytest.mark.parametrize("pos", [0, 5, 30, [2, 31]])
def test_cache_write_clamps_like_dynamic_update_slice(pos):
    """A start past S - C is clamped as jax.lax.dynamic_update_slice
    clamps it: no write leaves the cache."""
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((2, 32, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    want = jax_attn.cache_write(jnp.asarray(cache), jnp.asarray(new),
                                jnp.asarray(pos, jnp.int32))
    got = attn.cache_write(torch.from_numpy(cache.copy()),
                           torch.from_numpy(new), torch.tensor(pos))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_mixed_policy_runs_bf16_with_fp32_logits(lm):
    _, cfg, _, params = lm
    eng = make_engine("eager", "mixed", device="cpu")
    tokens = torch.arange(6).reshape(1, 6)
    with torch.inference_mode():
        logits, caches = serve_step.make_prefill_step(eng, cfg)(params,
                                                                tokens)
    assert logits.dtype == torch.float32
    assert caches[0]["k"].dtype == torch.bfloat16
    assert torch.isfinite(logits).all()


def test_mixed_policy_matches_jax(lm):
    """`mixed` on `eager` against JAX `xla` `mixed`: prefill logits, one
    decode step from the prefill's caches (fed JAX's greedy token) and the
    training loss, at the bf16 bar.  The two packages round bf16 at other
    places (each op's cast), so this is the bar and not 1e-4."""
    jcfg, cfg, jparams, params = lm
    jeng = jax_make_engine("xla", "mixed")
    eng = make_engine("eager", "mixed", device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlogits, jpre = jax_serve_step.make_prefill_step(jeng, jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, pre = serve_step.make_prefill_step(eng, cfg)(
            params, torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32
    assert pre[0]["k"].dtype == torch.bfloat16
    assert _relmax(logits, jlogits) <= MIXED_TOL

    nxt = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    jcaches = [{k: c[k].at[:, :, :16].set(p[k]) for k in c} for c, p in zip(
        jax_kvcache.cache_init(jcfg, 2, 32, jnp.bfloat16), jpre)]
    jdec = jax_serve_step.make_decode_step(jeng, jcfg)(
        jparams, jcaches, jnp.asarray(nxt), jnp.asarray([16, 16], jnp.int32))[0]
    caches = kvcache.cache_init(cfg, 2, 32, torch.bfloat16)
    with torch.inference_mode():
        for name in ("k", "v"):
            caches[0][name][:, :, :16] = pre[0][name]
        dec, _ = serve_step.make_decode_step(eng, cfg)(
            params, caches, torch.from_numpy(nxt).long(),
            torch.tensor([16, 16]))
    assert _relmax(dec, jdec) <= MIXED_TOL

    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jloss = jax_tfm.loss_fn(jeng, jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=False, ce_chunk=8)
    with torch.no_grad():
        loss = tfm.loss_fn(eng, cfg, params,
                           {k: torch.from_numpy(v).long()
                            for k, v in batch.items()},
                           remat=False, ce_chunk=8)
    assert abs(loss.item() - float(jloss)) <= MIXED_TOL * abs(float(jloss))
