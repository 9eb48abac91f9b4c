"""The port's LM training path against the JAX package, on the CPU.

`reduced(qwen2-0.5b)` (2 layers, d 128, 4 heads over 2 kv-heads of 32,
QKV bias, tied embeddings) with the JAX parameters (random QKV biases)
carried across by `convert.lm_params_from_jax` and the AdamW state by
`convert.opt_state_from_jax`; batches from `SyntheticLM`.  The port runs
on the `eager` backend; JAX on `xla`.  Bars: the loss 1e-5 relative, every
gradient, parameter and moment 1e-4 max-relative (two fp32 programs, two
layers of GEMMs and a 512-way softmax).  Also: the data pipeline's batches
bitwise, error-feedback compression, checkpoints (round trip, atomicity,
retention), a crash and restart of `train_loop` giving bit-identical
parameters, and the tied head's gradient through ``embed.t()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import common as jax_common
from repro.models import transformer as jax_tfm
from repro.train import compression as jax_comp
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import base
from repro_torch.core import make_engine
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.fault import FailureInjected, StepWatchdog
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.train import compression
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten, unflatten_like

torch.set_num_threads(1)

LOSS_TOL, TOL = 1e-5, 1e-4
ENGINE = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")
B, S, CE_CHUNK = 2, 16, 8


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_trees_close(got: dict, want: dict, tol: float, what: str):
    flat_g = flatten(got)
    flat_w = flatten(want)
    assert set(flat_g) == set(flat_w), what
    for name, w in flat_w.items():
        g = flat_g[name]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        err = _relmax(g, w)
        assert err <= tol, f"{what} {name}: {err:.3e}"


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    cfg = base.reduced(base.get_arch("qwen2-0.5b"))
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    stack = jparams["stacks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        stack[name] = jnp.asarray(
            rng.standard_normal(stack[name].shape).astype(np.float32) * 0.1)
    return jcfg, cfg, jparams


def _port_params(jparams, cfg):
    return convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)


def _batch(cfg, step=0, b=B, s=S):
    return SyntheticLM(cfg, base.ShapeConfig("t", s, b, "train"),
                       seed=3).batch(step)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ data ---

@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batches_equal_the_jax_pipeline_bitwise(lm, step):
    jcfg, cfg, _ = lm
    mine = SyntheticLM(cfg, base.ShapeConfig("t", 24, 3, "train"), seed=7)
    theirs = JaxSyntheticLM(jcfg, jax_base.ShapeConfig("t", 24, 3, "train"),
                            seed=7)
    a, b = mine.batch(step), theirs.batch(step)
    assert set(a) == set(b) == {"tokens", "labels"}
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key])


def test_prefetcher_yields_the_pipeline_in_order(lm):
    _, cfg, _ = lm
    src = SyntheticLM(cfg, base.ShapeConfig("t", 8, 2, "train"), seed=1)
    pf = Prefetcher(src, start_step=4)
    try:
        for step in (4, 5, 6):
            got_step, batch = pf.next()
            assert got_step == step
            assert np.array_equal(batch["tokens"], src.batch(step)["tokens"])
    finally:
        pf.close()


# ------------------------------------------------------------------ loss ---

def test_chunked_cross_entropy_matches_jax(lm):
    _, cfg, jparams = lm
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = np.asarray(jparams["embed"]["tokens"])

    def jloss(h, e):
        return jax_common.chunked_cross_entropy(
            JAX_ENGINE, h, e.T, jnp.asarray(labels),
            vocab_real=cfg.vocab_size, chunk=CE_CHUNK)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1))(h, table)
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.from_numpy(table.copy()).requires_grad_()
    val = common.chunked_cross_entropy(
        ENGINE, ht, et.t(), torch.from_numpy(labels),
        vocab_real=cfg.vocab_size, chunk=CE_CHUNK)
    grads = torch.autograd.grad(val, (ht, et))
    assert abs(val.item() - float(jval)) <= LOSS_TOL * abs(float(jval))
    for g, w in zip(grads, jgrads):
        assert _relmax(g, w) <= TOL
    with pytest.raises(ValueError, match="multiple"):
        common.chunked_cross_entropy(ENGINE, ht[:, :12], et.t(),
                                     torch.from_numpy(labels[:, :12]),
                                     vocab_real=cfg.vocab_size, chunk=8)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_and_gradients_match_jax(lm, remat):
    jcfg, cfg, jparams = lm
    batch = _batch(cfg)
    jval, jgrads = jax.value_and_grad(
        lambda p: jax_tfm.loss_fn(JAX_ENGINE, jcfg, p,
                                  jax.tree_util.tree_map(jnp.asarray, batch),
                                  remat=remat, ce_chunk=CE_CHUNK))(jparams)
    params = _port_params(jparams, cfg)
    leaves = {k: p.requires_grad_() for k, p in flatten(params).items()}
    val = tfm.loss_fn(ENGINE, cfg, params, _torch_batch(batch), remat=remat,
                      ce_chunk=CE_CHUNK)
    grads = dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))
    assert abs(val.item() - float(jval)) <= LOSS_TOL * abs(float(jval))
    want = convert.lm_params_to_numpy(
        convert.lm_params_from_jax(_jax_numpy(jgrads), cfg), cfg)
    got = convert.lm_params_to_numpy(unflatten_like(grads, params), cfg)
    _assert_trees_close(got, want, TOL, "gradient")


def test_remat_does_not_change_the_gradients(lm):
    _, cfg, jparams = lm
    batch = _torch_batch(_batch(cfg))
    out = []
    for remat in (True, False):
        params = _port_params(jparams, cfg)
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_()
        val = tfm.loss_fn(ENGINE, cfg, params, batch, remat=remat,
                          ce_chunk=CE_CHUNK)
        out.append((val, torch.autograd.grad(val, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ------------------------------------------------------------------ step ---

def test_three_train_steps_match_the_jax_step(lm):
    jcfg, cfg, jparams = lm
    ocfg_args = dict(lr=1e-3, warmup_steps=1, decay_steps=3)
    jstep = jax.jit(jax_make_train_step(JAX_ENGINE, jcfg,
                                        jax_opt.AdamWConfig(**ocfg_args),
                                        ce_chunk=CE_CHUNK))
    step = make_train_step(ENGINE, cfg, opt.AdamWConfig(**ocfg_args),
                           ce_chunk=CE_CHUNK)
    jp, jst = jparams, jax_opt.adamw_init(jparams)
    params = _port_params(jparams, cfg)
    state = convert.opt_state_from_jax(_jax_numpy(jst), cfg)
    for i in range(3):
        batch = _batch(cfg, i)
        jp, jst, jm = jstep(jp, jst, jax.tree_util.tree_map(jnp.asarray,
                                                            batch))
        params, state, m = step(params, state, _torch_batch(batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_TOL * abs(float(jm["loss"])), f"step {i + 1} loss"
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * float(jm["grad_norm"])
        assert m["step"] == int(jm["step"]) == i + 1
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    _assert_trees_close(convert.lm_params_to_numpy(params, cfg), _jax_numpy(jp),
                        TOL, "params")
    back = convert.opt_state_to_numpy(state, params, cfg)
    for key in ("mu", "nu"):
        _assert_trees_close(back[key], _jax_numpy(jst[key]), TOL, key)
    assert int(back["step"]) == int(jst["step"]) == 3


def test_microbatch_equivalence(lm):
    """Two microbatches give the step of one big batch (linearity)."""
    _, cfg, jparams = lm
    ocfg = opt.AdamWConfig()
    batch = _torch_batch(_batch(cfg, b=4))
    runs = []
    for m in (1, 2):
        params = _port_params(jparams, cfg)
        state = opt.adamw_init(flatten(params))
        step = make_train_step(ENGINE, cfg, ocfg, num_microbatches=m,
                               ce_chunk=CE_CHUNK)
        runs.append(step(params, state, batch))
    (p1, _, m1), (p2, _, m2) = runs
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= \
        1e-5 * abs(float(m1["loss"]))
    for name, a in flatten(p1).items():
        b = flatten(p2)[name]
        assert torch.allclose(a, b, rtol=5e-4, atol=5e-5), name
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(ENGINE, cfg, ocfg, num_microbatches=3)(
            p1, opt.adamw_init(flatten(p1)), batch)


def test_train_step_with_compression_feeds_back_the_residual(lm):
    """With ``grad_compression`` the step applies AdamW to the int8 round
    trip of its gradients and returns the residual, which the next step
    adds back (the compressor itself is held to JAX below; two programs'
    gradients may round to neighbouring int8 levels, so the compressed
    trajectories are not compared across packages)."""
    _, cfg, jparams = lm
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = _torch_batch(_batch(cfg))
    step = make_train_step(ENGINE, cfg, ocfg, ce_chunk=CE_CHUNK,
                           grad_compression=True)
    params = _port_params(jparams, cfg)
    leaves = {k: p.clone().requires_grad_()
              for k, p in flatten(params).items()}
    val = tfm.loss_fn(ENGINE, cfg, unflatten_like(leaves, params), batch,
                      ce_chunk=CE_CHUNK)
    grads = dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))
    g_hat, want_err = compression.ef_compress_tree(grads)
    want = {k: p.detach().clone() for k, p in leaves.items()}
    opt.adamw_update(ocfg, opt.clip_by_global_norm(g_hat, ocfg.clip_norm)[0],
                     opt.adamw_init(want), want)
    params, state, err, m = step(params, opt.adamw_init(flatten(params)),
                                 batch)
    assert torch.equal(m["loss"], val.detach())
    assert set(err) == set(grads)
    assert all(torch.equal(err[k], e) for k, e in want_err.items())
    assert all(torch.equal(flatten(params)[k], p) for k, p in want.items())
    _, _, err2, _ = step(params, state, batch, err)
    assert set(err2) == set(err) and not all(
        torch.equal(err2[k], e) for k, e in err.items())


def test_ef_compression_round_trip_and_error_feedback():
    rng = np.random.default_rng(0)
    g_np = rng.standard_normal(256).astype(np.float32)
    g = torch.from_numpy(g_np)
    g_hat, err = compression.ef_compress(g, None)
    jg_hat, jerr = jax_comp.ef_compress(jnp.asarray(g_np), None)
    assert _relmax(g_hat, jg_hat) <= 1e-6
    assert float((g - g_hat).abs().max()) <= float(g.abs().max()) / 127 * .51
    assert torch.equal(err, g - g_hat)
    total_hat, err = torch.zeros_like(g), None
    for _ in range(50):
        step_hat, err = compression.ef_compress(g, err)
        total_hat += step_hat
    assert float((total_hat / 50 - g).abs().max()) < 1e-3
    tree_hat, tree_err = compression.ef_compress_tree({"a": g, "b": 2 * g})
    assert set(tree_hat) == set(tree_err) == {"a", "b"}
    assert torch.equal(tree_hat["a"], g_hat)
    top = compression.topk_compress(g, 0.05)
    jtop = jax_comp.topk_compress(jnp.asarray(g_np), 0.05)
    assert np.array_equal(top.numpy(), np.asarray(jtop))
    assert int((top != 0).sum()) == int(256 * 0.05)


# ------------------------------------------------------------- tied head ---

def test_tied_head_gradient_equals_a_row_major_copy():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((12, 32)).astype(np.float32))
    table = rng.standard_normal((96, 32)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal((12, 96)).astype(np.float32))
    e = torch.from_numpy(table).requires_grad_()
    w = torch.from_numpy(table.T.copy()).requires_grad_()
    xs = [x.clone().requires_grad_() for _ in range(2)]
    y_t = ops.matmul(xs[0], e.t())
    y_r = ops.matmul(xs[1], w)
    assert torch.equal(y_t, y_r)
    dx_t, de = torch.autograd.grad(y_t, (xs[0], e), dy)
    dx_r, dw = torch.autograd.grad(y_r, (xs[1], w), dy)
    assert torch.equal(dx_t, dx_r)
    assert de.shape == e.shape and torch.equal(de, dw.t())


# ----------------------------------------------------------- checkpoints ---

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": {"tokens": torch.randn(6, 4, generator=g)},
              "layers": [{"w": torch.randn(4, 4, generator=g)}
                         for _ in range(2)]}
    state = opt.adamw_init(flatten(params))
    state["step"] = 7
    return params, state


def test_checkpoint_round_trip(tmp_path):
    tree = _tree(0)
    d = str(tmp_path)
    final = ckpt.save(d, 5, tree, extra={"arch": "x"})
    assert final.endswith("step_00000005")
    assert ckpt.latest_step(d) == 5
    like = _tree(1)
    (params, state), manifest = ckpt.restore(d, 5, like)
    assert manifest["step"] == 5 and manifest["extra"] == {"arch": "x"}
    assert "0.layers.1.w" in manifest["names"]
    assert state["step"] == 7 and isinstance(state["step"], int)
    for name, t in flatten(tree).items():
        got = flatten((params, state))[name]
        if isinstance(t, torch.Tensor):
            assert torch.equal(got, t) and got.dtype == t.dtype, name
    with pytest.raises(KeyError):
        ckpt.restore(d, 5, ({"other": torch.zeros(1)}, state))


def test_checkpoint_is_atomic_and_retains_the_newest(tmp_path):
    d = str(tmp_path)
    tree = _tree(0)
    for step in (1, 2, 3, 4):
        ckpt.save(d, step, tree)
    # a crash mid-write leaves a .tmp directory, which is never a checkpoint
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ckpt.latest_step(d) == 4
    ckpt.save(d, 4, _tree(2))                     # overwrite in place
    (params, _), _ = ckpt.restore(d, 4, _tree(0))
    assert torch.equal(params["embed"]["tokens"],
                       _tree(2)[0]["embed"]["tokens"])
    ckpt.retain(d, keep=2)
    left = sorted(p.name for p in tmp_path.iterdir()
                  if not p.name.endswith(".tmp"))
    assert left == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


# --------------------------------------------------------------- trainer ---

class _StragglerAt(StepWatchdog):
    """A watchdog that reads no clock: it flags exactly the steps in
    `steps` as stragglers (so `train_loop` checkpoints after them) and no
    other."""

    def __init__(self, steps=()):
        super().__init__(threshold=float("inf"))
        self.steps = set(steps)

    def start(self):
        pass

    def stop(self, step: int) -> dict:
        flagged = step in self.steps
        return {"step_time_s": 0.0, "ewma_s": 0.0, "straggler": flagged,
                "checkpoint_now": flagged, "recommend_evict": False}


def _crash_and_restart(cfg, tmp_path, resume_from):
    """Six steps straight vs a crash at step 4 and a restart from the
    newest checkpoint, which must be step `resume_from`; asserts the same
    losses and bit-identical parameters and moments."""
    args = dict(steps=6, batch=2, seq=16, ckpt_every=3, log_every=100,
                engine=ENGINE)
    m_ref: list = []
    p_ref, s_ref = launch_train.train_loop(cfg, ckpt_dir=str(tmp_path / "a"),
                                           metrics_out=m_ref, **args)
    m_crash: list = []
    with pytest.raises(FailureInjected):
        launch_train.train_loop(cfg, ckpt_dir=str(tmp_path / "b"),
                                fail_at_step=4, metrics_out=m_crash, **args)
    assert ckpt.latest_step(str(tmp_path / "b")) == resume_from
    p_got, s_got = launch_train.train_loop(cfg, ckpt_dir=str(tmp_path / "b"),
                                           metrics_out=m_crash, **args)
    ref = {m["step"]: m["loss"] for m in m_ref}
    got = {m["step"]: m["loss"] for m in m_crash}
    assert set(got) == set(ref) == set(range(6))
    assert all(got[s] == ref[s] for s in ref)
    for name, t in flatten(p_ref).items():
        assert torch.equal(flatten(p_got)[name], t), name
    assert s_got["step"] == s_ref["step"] == 6
    assert all(torch.equal(s_got["nu"][k], v) for k, v in s_ref["nu"].items())


def test_crash_restart_is_bit_identical(lm, tmp_path, monkeypatch):
    """Six steps straight vs a crash at step 3 and a restart from the
    step-3 checkpoint: the same losses and bit-identical parameters.  The
    watchdog reads no clock and never flags a step, so no straggler
    checkpoint (step 4 under a slow step) can move the restart point."""
    _, cfg, _ = lm
    monkeypatch.setattr(launch_train, "StepWatchdog", _StragglerAt)
    _crash_and_restart(cfg, tmp_path, resume_from=3)


def test_crash_restart_from_a_straggler_checkpoint_is_bit_identical(
        lm, tmp_path, monkeypatch):
    """As above with step index 3 flagged as a straggler: `train_loop`
    checkpoints after it (step 4) besides the every-3 checkpoint, the
    restart resumes from step 4 and is still bit-identical."""
    _, cfg, _ = lm
    monkeypatch.setattr(launch_train, "StepWatchdog",
                        lambda: _StragglerAt({3}))
    _crash_and_restart(cfg, tmp_path, resume_from=4)


def test_train_loop_defaults_to_the_card(lm, monkeypatch):
    _, cfg, _ = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train_loop(cfg, steps=1, batch=1, seq=8, ckpt_dir="")


def test_main_parses_the_jax_trainers_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(launch_train, "train_loop",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    launch_train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--microbatches", "2",
                       "--fail-at-step", "1"])
    assert seen["cfg"] == base.reduced(base.get_arch("qwen2-0.5b"))
    assert (seen["steps"], seen["batch"], seen["seq"],
            seen["num_microbatches"], seen["fail_at_step"]) == (3, 2, 16, 2, 1)
