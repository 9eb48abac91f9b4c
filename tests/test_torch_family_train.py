"""The port's training of the SSM, audio, hybrid and MoE families against
JAX.

`loss_fn` and its gradient with respect to every parameter, on the
`eager` backend, against ``jax.value_and_grad`` of the JAX `loss_fn` on
`xla`, for reduced mamba2-1.3b (2 layers, 8 SSD heads of 32, chunk 32:
three chunks of a 80-token sequence, the last ragged), reduced
hubert-xlarge at its head dim of 80 (4 MHA heads, not causal, frames of
64) and reduced zamba2-7b at its head dim of 112 with a one-layer mamba
tail (two super entries of 2 mamba layers and the shared block, then 1
mamba layer), reduced deepseek-v2-lite-16b at MLA's head dim of 192
(qk_nope 128 + qk_rope 64: a `mla_dense` and a `mla_moe` layer, so the
attention's backward wrappers run at 192) and reduced llama4-scout (two
`gqa_moe` layers, top-1 and a shared expert), remat on and off; the MoE
layers' expert einsums run their gradients through the engine as on the
card's `BmmFn`.  The JAX parameters are carried across
by `convert.lm_params_from_jax` (the mixers' dt bias, A and D and the
frontend's biases moved off their init, so every parameter reaches the
loss; hubert reads no token table, whose gradient is then 0 on both
sides) and the gradients back by `convert.lm_params_to_numpy`; inputs come
from numpy seeds.  Bars those of tests/test_torch_lm_train.py: the loss
1e-5 relative, every gradient 1e-4 max-relative.  The same step on
`cuda` against `eager` runs on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Also two `make_train_step` steps of hubert in two
microbatches against the JAX step: the token table it never reads gets a
zero gradient, and the batch splits along its labels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.models import transformer as jax_tfm
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import make_engine
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten, unflatten_like

torch.set_num_threads(1)

LOSS_TOL, TOL = 1e-5, 1e-4
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
CE_CHUNK = 16

# name -> (arch, config overrides, batch, sequence)
MODELS = {
    "mamba2": ("mamba2-1.3b", {}, 2, 80),
    "hubert_80": ("hubert-xlarge", {"head_dim": 80}, 2, 32),
    "zamba2_112_tail": ("zamba2-7b", {"n_layers": 5, "head_dim": 112}, 2,
                        48),
    "deepseek_192": ("deepseek-v2-lite-16b", {"qk_nope_dim": 128,
                                              "qk_rope_dim": 64,
                                              "head_dim": 192}, 2, 32),
    "llama4": ("llama4-scout-17b-a16e", {}, 2, 32),
}


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_BUILT: dict = {}


def _model(name):
    """(jcfg, cfg, JAX params, JAX batch, port batch), built once."""
    if name in _BUILT:
        return _BUILT[name]
    arch, over, b, s = MODELS[name]
    jcfg = dataclasses.replace(jax_base.reduced(jax_base.get_arch(arch)),
                               **over)
    cfg = dataclasses.replace(base.reduced(base.get_arch(arch)), **over)
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    for stack in jparams.get("stacks", []):
        mixer = stack.get("mixer")
        if mixer is None:
            continue
        for key, scale in (("dt_bias", 0.5), ("A_log", 0.3), ("D", 0.5)):
            mixer[key] = mixer[key] + jnp.asarray(rng.standard_normal(
                mixer[key].shape).astype(np.float32) * scale)
    if "frontend" in jparams:
        jparams["frontend"] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(
                a.shape).astype(np.float32)), jparams["frontend"])
    drng = np.random.default_rng(2)
    batch = {"labels": drng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = drng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = drng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    _BUILT[name] = (jcfg, cfg, jparams,
                    {k: jnp.asarray(v) for k, v in batch.items()}, tbatch)
    return _BUILT[name]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_loss_fn_and_gradients_match_jax(name, remat):
    jcfg, cfg, jparams, jbatch, batch = _model(name)
    jval, jgrads = jax.value_and_grad(
        lambda p: jax_tfm.loss_fn(JAX_ENGINE, jcfg, p, jbatch, remat=remat,
                                  ce_chunk=CE_CHUNK))(jparams)
    params = convert.lm_params_from_jax(_jax_numpy(jparams), cfg)
    leaves = {k: p.requires_grad_() for k, p in flatten(params).items()}
    val = tfm.loss_fn(ENGINE, cfg, params, batch, remat=remat,
                      ce_chunk=CE_CHUNK)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), torch.autograd.grad(
                 val, list(leaves.values()), allow_unused=True))}
    assert abs(val.item() - float(jval)) <= LOSS_TOL * abs(float(jval))
    want = convert.lm_params_to_numpy(
        convert.lm_params_from_jax(_jax_numpy(jgrads), cfg), cfg)
    got = convert.lm_params_to_numpy(unflatten_like(grads, params), cfg)
    flat_g, flat_w = flatten(got), flatten(want)
    assert set(flat_g) == set(flat_w)
    for key, w in flat_w.items():
        g = flat_g[key]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert np.isfinite(g).all(), key
        err = _relmax(g, w)
        assert err <= TOL, f"gradient {key}: {err:.3e}"


def test_audio_train_step_in_microbatches_matches_the_jax_step():
    jcfg, cfg, jparams, jbatch, batch = _model("hubert_80")
    ocfg_args = dict(lr=1e-3, warmup_steps=1, decay_steps=2)
    jstep = jax.jit(jax_make_train_step(
        JAX_ENGINE, jcfg, jax_opt.AdamWConfig(**ocfg_args),
        num_microbatches=2, ce_chunk=CE_CHUNK))
    step = make_train_step(ENGINE, cfg, opt.AdamWConfig(**ocfg_args),
                           num_microbatches=2, ce_chunk=CE_CHUNK)
    jp, jst = jparams, jax_opt.adamw_init(jparams)
    params = convert.lm_params_from_jax(_jax_numpy(jparams), cfg)
    state = convert.opt_state_from_jax(_jax_numpy(jst), cfg)
    for i in range(2):
        jp, jst, jm = jstep(jp, jst, jbatch)
        params, state, m = step(params, state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_TOL * abs(float(jm["loss"])), f"step {i + 1} loss"
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * float(jm["grad_norm"])
    # The first moments, linear in the gradients.  The parameters are not
    # held to TOL here: AdamW's division by sqrt(nu) turns the rounding of
    # the few gradient elements near 0 (2 of wo's 81,920 below 1e-6 of
    # its largest) into whole steps of lr, as chip_smoke.py's train phases
    # set out.
    mu = convert.opt_state_to_numpy(state, params, cfg)["mu"]
    for key, w in flatten(_jax_numpy(jst["mu"])).items():
        assert _relmax(flatten(mu)[key], w) <= TOL, key
