"""The port's training path against the JAX package's, on the CPU.

Same inputs, made once with numpy, go through `jax.grad` of the JAX package
and through PyTorch autograd of the port:

* engine `matmul` and `conv2d` gradients on `eager` against the JAX `xla`
  engine (every operand's cotangent, scale and shift included);
* `GemmFused` on CPU tensors, which runs the plain versions of the three
  kernels, against `jax.grad` through the `pallas` backend in interpret mode;
* `cnn_loss_fn` and its gradient on `DARKNET_SMALL_CFG`, and a
  sum-of-squares loss through `SEGNET_SMALL_CFG` (the deconv path), with the
  JAX parameters carried over by `params_from_jax`;
* AdamW, SGD-momentum and the schedule, and three `make_cnn_train_step`
  steps.

Tolerances: fp32 gradients, moments and schedule 1e-5 max-relative (the
`_relmax` and bar of tests/test_grad_conformance.py: two fp32 programs
summing in different orders).  Parameters after three train steps 1e-4:
an AdamW step divides each moment by its own square root, so near-zero
gradient elements carry their rounding differences into the update
undamped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import darknet_ref as jax_cfgs
from repro.core import make_engine as jax_make_engine
from repro.core.darknet.network import Network as JaxNetwork
from repro.train import optimizer as jax_opt
from repro.train.train_step import cnn_loss_fn as jax_cnn_loss_fn
from repro.train.train_step import make_cnn_train_step as jax_make_step
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG, SEGNET_SMALL_CFG
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import backends, make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.common import ACTIVATIONS
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import cnn_loss_fn, make_cnn_train_step

torch.set_num_threads(1)

FP32_TOL = 1e-5
UPDATE_TOL = 1e-4
MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99)]
CONV_CASES = [
    (2, 28, 28, 3, 16, 3, 1, 1),
    (2, 14, 14, 16, 32, 3, 1, 1),
    (2, 7, 7, 32, 64, 3, 1, 1),
    (1, 9, 11, 5, 7, 3, 2, 1),
]


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _assert_close(got, want, tol, names):
    for name, a, b in zip(names, got, want):
        rel = _relmax(a, b)
        assert rel <= tol, f"d{name}: rel err {rel:.2e} > {tol:g}"


def _eager():
    return make_engine("eager", device="cpu")


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _grads(loss, tensors):
    return [g.numpy() for g in torch.autograd.grad(loss, tensors)]


# ------------------------------------------------------------ engine ops ---

def _matmul_operands(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            (rng.standard_normal(n) * 0.2).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))  # cotangent


def _jax_matmul_grads(backend, ops_np, act):
    eng = jax_make_engine(backend)
    *args, ct = (jnp.asarray(a) for a in ops_np)

    def loss(x, w, sc, sh):
        return jnp.sum(eng.matmul(x, w, scale=sc, shift=sh, act=act) * ct)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_engine_matmul_grads_match_jax(m, k, n, act):
    ops_np = _matmul_operands(m, k, n)
    want = _jax_matmul_grads("xla", ops_np, act)
    x, w, sc, sh = _leaves(*ops_np[:4])
    y = _eager().matmul(x, w, scale=sc, shift=sh, act=act)
    got = _grads((y * torch.from_numpy(ops_np[4])).sum(), [x, w, sc, sh])
    _assert_close(got, want, FP32_TOL, ("x", "w", "scale", "shift"))


@pytest.mark.parametrize("case", CONV_CASES)
def test_engine_conv2d_grads_match_jax(case):
    b, h, w_, cin, cout, size, stride, pad = case
    rng = np.random.default_rng(h * 100 + cin + cout)
    x_np = rng.standard_normal((b, h, w_, cin)).astype(np.float32)
    w_np = (rng.standard_normal((size * size * cin, cout)) * 0.2
            ).astype(np.float32)
    sc_np = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    sh_np = (rng.standard_normal(cout) * 0.2).astype(np.float32)
    kw = dict(size=size, stride=stride, pad=pad, act="leaky")
    jeng = jax_make_engine("xla")

    def loss(x, w, sc, sh):
        y = jeng.conv2d(x, w, scale=sc, shift=sh, **kw)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x_np, w_np, sc_np, sh_np)))
    x, w, sc, sh = _leaves(x_np, w_np, sc_np, sh_np)
    y = _eager().conv2d(x, w, scale=sc, shift=sh, **kw)
    got = _grads((y ** 2).sum(), [x, w, sc, sh])
    _assert_close(got, [np.asarray(g) for g in want], FP32_TOL,
                  ("x", "w", "scale", "shift"))


@pytest.mark.parametrize("m,k,n,act", [(33, 177, 99, "leaky"),
                                       (32, 128, 256, "gelu")])
def test_gemm_fused_plain_backward_matches_jax_pallas(m, k, n, act):
    """`ops.matmul` with grad goes through `GemmFused`; on CPU tensors its
    three kernel wrappers run their plain versions.  The JAX side runs its
    custom-VJP Pallas kernels in interpret mode."""
    ops_np = _matmul_operands(m, k, n)
    want = _jax_matmul_grads("pallas", ops_np, act)
    x, w, sc, sh = _leaves(*ops_np[:4])
    before = gemm.launch_counts()
    y = ops.matmul(x, w, sc, sh, act=act)
    assert type(y.grad_fn).__name__ == "GemmFusedBackward"
    got = _grads((y * torch.from_numpy(ops_np[4])).sum(), [x, w, sc, sh])
    assert gemm.launch_counts() == before  # CPU tensors launch nothing
    _assert_close(got, want, FP32_TOL, ("x", "w", "scale", "shift"))


def test_gemm_fused_skips_dx_when_x_needs_no_grad(monkeypatch):
    calls = []
    real = gemm.gemm_bwd_dx
    monkeypatch.setattr(gemm, "gemm_bwd_dx",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x_np, w_np, sc_np, sh_np, _ = _matmul_operands(33, 177, 99)
    w, sc = _leaves(w_np, sc_np)
    y = ops.matmul(torch.from_numpy(x_np), w, sc, torch.from_numpy(sh_np),
                   act="relu")
    y.sum().backward()
    assert calls == [] and w.grad is not None and sc.grad is not None
    x = torch.from_numpy(x_np).requires_grad_()
    ops.matmul(x, w, sc, None, act="relu").sum().backward()
    assert calls == [1] and x.grad is not None


def test_matmul_without_grad_makes_the_serving_launch():
    x_np, w_np, *_ = _matmul_operands(2, 64, 10)
    w = torch.from_numpy(w_np).requires_grad_()
    with torch.no_grad():
        y = ops.matmul(torch.from_numpy(x_np), w)
    assert y.grad_fn is None and not y.requires_grad
    y = ops.matmul(torch.from_numpy(x_np), w.detach())
    assert y.grad_fn is None


# ------------------------------------------------------------- networks ---

def _jax_tree(cfg_text, seed=0):
    """JAX `Network.init` as numpy, with randomized BN statistics."""
    net = JaxNetwork(cfg_text, jax_make_engine("xla"))
    tree = net.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    out = {}
    for layer, leaves in tree.items():
        out[layer] = {}
        for name, v in leaves.items():
            v = np.asarray(v, np.float32)
            if name in ("gamma", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif name in ("beta", "mean", "b"):
                v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            out[layer][name] = v
    return out


def _pair(cfg_text, seed=0):
    tree = _jax_tree(cfg_text, seed)
    jnet = JaxNetwork(cfg_text, jax_make_engine("xla"))
    net = Network(cfg_text, _eager())
    net.load_state_dict(params_from_jax(tree))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jnet, jparams, net


def _batch(net, b, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *net.in_shape)).astype(np.float32)
    labels = rng.integers(0, net.out_shape[-1], b)
    return x, labels


def _assert_trees_close(got, want, tol):
    for layer, leaves in want.items():
        for name, b in leaves.items():
            rel = _relmax(got[layer][name], b)
            assert rel <= tol, f"{layer}.{name}: {rel:.2e} > {tol:g}"


def test_cnn_loss_and_grads_match_jax():
    jnet, jparams, net = _pair(jax_cfgs.DARKNET_SMALL_CFG)
    x, labels = _batch(net, 2)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_cnn_loss_fn(jnet, p, jnp.asarray(x),
                                  jnp.asarray(labels)))(jparams)
    params = dict(net.named_parameters())
    loss = cnn_loss_fn(net, torch.from_numpy(x), torch.from_numpy(labels))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert _relmax(loss.item(), float(want_loss)) <= FP32_TOL
    assert len(grads) == 17  # every leaf, BN mean and var included
    _assert_trees_close(params_to_numpy(grads),
                        jax.tree.map(np.asarray, want), FP32_TOL)


def test_segnet_sum_of_squares_grads_match_jax():
    """The deconv layer (GEMM + col2im in the forward) differentiates."""
    jnet, jparams, net = _pair(jax_cfgs.SEGNET_SMALL_CFG, seed=2)
    x, _ = _batch(net, 2, seed=6)
    want = jax.grad(lambda p: jnp.sum(
        jnet.apply(p, jnp.asarray(x)).astype(jnp.float32) ** 2))(jparams)
    params = dict(net.named_parameters())
    loss = (net(torch.from_numpy(x)).float() ** 2).sum()
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    _assert_trees_close(params_to_numpy(grads),
                        jax.tree.map(np.asarray, want), FP32_TOL)


def test_params_to_numpy_inverts_params_from_jax():
    tree = _jax_tree(jax_cfgs.DARKNET_SMALL_CFG)
    back = params_to_numpy(params_from_jax(tree))
    assert back.keys() == tree.keys()
    for layer in tree:
        for name, v in tree[layer].items():
            np.testing.assert_array_equal(back[layer][name], v)


# ------------------------------------------------------------ optimizer ---

def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"l0": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                   "gamma": rng.uniform(0.5, 1.5, 5).astype(np.float32)},
            "l3": {"b": rng.standard_normal(7).astype(np.float32)}}


def _flat(tree):
    return {k: v.clone() for k, v in params_from_jax(tree).items()}


def test_adamw_update_matches_jax_over_five_steps():
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=8)
    jcfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=8)
    tree = _random_tree(0)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jax_opt.adamw_init(jp)
    params = _flat(tree)
    state = opt.adamw_init(params)
    for step in range(5):
        g = _random_tree(10 + step)
        jp, jstate, jlr = jax_opt.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, g), jstate, jp)
        params, state, lr = opt.adamw_update(cfg, _flat(g), state, params)
        assert state["step"] == int(jstate["step"]) == step + 1
        assert _relmax(lr, float(jlr)) <= FP32_TOL
    for key, want in (("mu", jstate["mu"]), ("nu", jstate["nu"])):
        _assert_trees_close(params_to_numpy(state[key]),
                            jax.tree.map(np.asarray, want), FP32_TOL)
    _assert_trees_close(params_to_numpy(params),
                        jax.tree.map(np.asarray, jp), FP32_TOL)


def test_sgdm_update_matches_jax_over_five_steps():
    tree = _random_tree(1)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jax_opt.sgdm_init(jp)
    params = _flat(tree)
    state = opt.sgdm_init(params)
    for step in range(5):
        g = _random_tree(20 + step)
        jp, jstate = jax_opt.sgdm_update(jax.tree.map(jnp.asarray, g),
                                         jstate, jp, lr=0.05)
        params, state = opt.sgdm_update(_flat(g), state, params, lr=0.05)
    assert state["step"] == int(jstate["step"]) == 5
    _assert_trees_close(params_to_numpy(state["mom"]),
                        jax.tree.map(np.asarray, jstate["mom"]), FP32_TOL)
    _assert_trees_close(params_to_numpy(params),
                        jax.tree.map(np.asarray, jp), FP32_TOL)


@pytest.mark.parametrize("step", [1, 100, 10_000, 20_000])
def test_schedule_matches_jax(step):
    """Step 1, the end of warmup, the end of decay, and past it."""
    want = float(jax_opt.schedule(jax_opt.AdamWConfig(),
                                  jnp.asarray(step, jnp.int32)))
    assert _relmax(opt.schedule(opt.AdamWConfig(), step), want) <= FP32_TOL


def test_clip_by_global_norm_matches_jax():
    tree = _random_tree(3)
    want, wnorm = jax_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), 1.0)
    got, norm = opt.clip_by_global_norm(_flat(tree), 1.0)
    assert _relmax(norm.item(), float(wnorm)) <= FP32_TOL
    _assert_trees_close(params_to_numpy(got), jax.tree.map(np.asarray, want),
                        FP32_TOL)


def test_three_train_steps_match_jax():
    jnet, jparams, net = _pair(jax_cfgs.DARKNET_SMALL_CFG, seed=4)
    cfg = dict(lr=1e-3, warmup_steps=1)
    jstep = jax_make_step(jnet, jax_opt.AdamWConfig(**cfg))
    step = make_cnn_train_step(net, opt.AdamWConfig(**cfg))
    jstate = jax_opt.adamw_init(jparams)
    state = opt.adamw_init(dict(net.named_parameters()))
    for i in range(3):
        x, labels = _batch(net, 2, seed=30 + i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    (jnp.asarray(x), jnp.asarray(labels)))
        state, m = step(state, (torch.from_numpy(x),
                                torch.from_numpy(labels)))
        assert _relmax(m["loss"].item(), float(jm["loss"])) <= FP32_TOL
        assert _relmax(m["grad_norm"].item(), float(jm["grad_norm"])
                       ) <= FP32_TOL
        assert m["step"] == int(jm["step"]) == i + 1
    _assert_trees_close(params_to_numpy(dict(net.named_parameters())),
                        jax.tree.map(np.asarray, jparams), UPDATE_TOL)
    for key in ("mu", "nu"):
        _assert_trees_close(params_to_numpy(state[key]),
                            jax.tree.map(np.asarray, jstate[key]),
                            UPDATE_TOL)


# ---------------------------------------------------------------- guard ---

def test_guard_raises_for_an_op_not_declared_differentiable():
    impl = backends.get_backend("eager").ops
    backends.register_backend("eager_nograd", impl, differentiable=(),
                              overwrite=True)
    try:
        eng = make_engine("eager_nograd", device="cpu")
        x = torch.randn(4, 8)
        w = torch.randn(8, 3, requires_grad=True)
        with pytest.raises(NotImplementedError,
                           match="'matmul' on backend 'eager_nograd'"):
            eng.matmul(x, w)
        with pytest.raises(NotImplementedError, match="'conv2d'"):
            eng.conv2d(torch.randn(1, 4, 4, 2), torch.randn(18, 3,
                       requires_grad=True), size=3, pad=1)
        with torch.no_grad():  # no grad wanted: the forward runs
            assert tuple(eng.matmul(x, w).shape) == (4, 3)
        assert tuple(eng.matmul(x, w.detach()).shape) == (4, 3)
    finally:
        backends._REGISTRY.pop("eager_nograd", None)


def test_builtin_backends_declare_their_ops_differentiable():
    for name in ("ref", "eager", "cuda"):
        be = backends.get_backend(name)
        assert be.supports_grad("matmul") and be.supports_grad("conv2d")
    with pytest.raises(ValueError, match="unregistered"):
        backends.register_backend("bad", {"matmul": None},
                                  differentiable=("conv2d",))
