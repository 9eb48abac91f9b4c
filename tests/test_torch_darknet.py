"""The port's Darknet path against the JAX package's, on the CPU.

Parameters are drawn by the JAX `Network.init`, given randomized batch-norm
statistics (the init values 1/0/0/1 would hide a wrong fold), carried into
the port by `repro_torch.convert.params_from_jax`, and both networks run on
the same numpy images: the JAX one on its `xla` engine, the port on its
`eager` engine.  Pre-softmax logits are held to 1e-4 max-relative (a dozen
chained fp32 layers summed in different orders), single engine ops and
layers to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import darknet_ref as jax_cfgs
from repro.core import make_engine as jax_make_engine
from repro.core.darknet import cfg as jax_cfg_mod
from repro.core.darknet import layers as jax_layers
from repro.core.darknet.network import Network as JaxNetwork
from repro_torch.configs.darknet_ref import (DARKNET19_CFG,
                                             DARKNET_SMALL_CFG,
                                             SEGNET_SMALL_CFG)
from repro_torch.convert import params_from_jax
from repro_torch.core import (Precision, assert_non_quantized,
                              counts_since, dispatch_counts, make_engine)
from repro_torch.core.darknet import cfg as cfg_mod
from repro_torch.core.darknet import layers
from repro_torch.core.darknet.network import Network

torch.set_num_threads(1)

FP32_TOL = 1e-5
LOGIT_TOL = 1e-4
CONV_CASES = [
    (2, 28, 28, 3, 16, 3, 1, 1),
    (2, 14, 14, 16, 32, 3, 1, 1),
    (2, 7, 7, 32, 64, 3, 1, 1),
    (1, 9, 11, 5, 7, 3, 2, 1),
]
# DARKNET19 with every channel width kept and the input cut to 64 x 64.
DARKNET19_64_CFG = DARKNET19_CFG.replace("height=224", "height=64").replace(
    "width=224", "width=64")
CFGS = {"darknet_small": DARKNET_SMALL_CFG, "segnet_small": SEGNET_SMALL_CFG,
        "darknet19_64": DARKNET19_64_CFG}


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _eager():
    return make_engine("eager", device="cpu")


def _jax_params(cfg_text: str, seed: int = 0) -> dict:
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


def _both_networks(cfg_text: str, seed: int = 0):
    tree = _jax_params(cfg_text, seed)
    jnet = JaxNetwork(cfg_text, jax_make_engine("xla"))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    net = Network(cfg_text, _eager())
    net.load_state_dict(params_from_jax(tree))
    return jnet, jparams, net


def _images(net, batch: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, *net.in_shape)).astype(np.float32)


# ----------------------------------------------------------- cfg and plan ---

@pytest.mark.parametrize("name", ["DARKNET_SMALL_CFG", "DARKNET19_CFG",
                                  "SEGNET_SMALL_CFG"])
def test_cfg_copies_parse_like_the_jax_package(name):
    from repro_torch.configs import darknet_ref
    text = getattr(darknet_ref, name)
    assert text == getattr(jax_cfgs, name)
    got = [(s.type, s.options) for s in cfg_mod.parse_cfg(text)]
    want = [(s.type, s.options) for s in jax_cfg_mod.parse_cfg(text)]
    assert got == want
    assert cfg_mod.parse_cfg(cfg_mod.dump_cfg(cfg_mod.parse_cfg(text))) == \
        cfg_mod.parse_cfg(text)


@pytest.mark.parametrize("cfg", list(CFGS))
def test_plan_and_parameter_layout_match_jax(cfg):
    text = CFGS[cfg]
    jnet = JaxNetwork(text, jax_make_engine("xla"))
    net = Network(text, _eager())
    assert [(p.index, p.type, p.out_shape) for p in net.plans] == \
        [(p.index, p.type, p.out_shape) for p in jnet.plans]
    tree = jnet.init(jax.random.PRNGKey(0))
    want = {f"{k}.{n}": tuple(v.shape) for k, leaves in tree.items()
            for n, v in leaves.items()}
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert net.num_params() == jnet.num_params(tree)


# --------------------------------------------------------------- networks ---

@pytest.mark.parametrize("cfg", list(CFGS))
def test_network_logits_match_jax(cfg):
    """Pre-softmax outputs (the cfg without its [softmax]) agree to 1e-4."""
    text = CFGS[cfg].replace("[softmax]", "")
    jnet, jparams, net = _both_networks(text)
    x = _images(net, 2)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _relmax(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("cfg", ["darknet_small", "darknet19_64"])
def test_network_probabilities_match_jax(cfg):
    jnet, jparams, net = _both_networks(CFGS[cfg], seed=3)
    x = _images(net, 2, seed=9)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert _relmax(got, want) <= LOGIT_TOL


def test_ref_and_eager_backends_agree_on_a_network():
    tree = _jax_params(DARKNET_SMALL_CFG)
    x = torch.from_numpy(_images(Network(DARKNET_SMALL_CFG, _eager()), 3))
    outs = []
    for backend in ("ref", "eager"):
        net = Network(DARKNET_SMALL_CFG, make_engine(backend, device="cpu"))
        net.load_state_dict(params_from_jax(tree))
        with torch.inference_mode():
            outs.append(net(x).numpy())
    assert _relmax(outs[0], outs[1]) <= FP32_TOL


def test_port_init_is_seeded_he_normal_and_non_quantized():
    a = Network(DARKNET_SMALL_CFG, _eager(),
                generator=torch.Generator().manual_seed(11))
    b = Network(DARKNET_SMALL_CFG, _eager(),
                generator=torch.Generator().manual_seed(11))
    c = Network(DARKNET_SMALL_CFG, _eager(),
                generator=torch.Generator().manual_seed(12))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["l0.w"], sc["l0.w"])
    assert torch.equal(sa["l0.gamma"], torch.ones(16))
    assert torch.equal(sa["l0.var"], torch.ones(16))
    w = sa["l4.w"]  # 3*3*32 fan-in
    assert abs(float(w.std()) - (2.0 / 288) ** 0.5) < 0.01
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in sa.values())
    assert_non_quantized(sa)
    with pytest.raises(ValueError, match="non-quantization"):
        assert_non_quantized({**sa, "l0.w": sa["l0.w"].to(torch.int8)})


# ------------------------------------------------------------ engine ops ---

@pytest.mark.parametrize("backend", ["eager", "ref"])
@pytest.mark.parametrize("b,h,w,cin,cout,size,stride,pad", CONV_CASES)
def test_engine_conv2d_matches_jax(backend, b, h, w, cin, cout, size, stride,
                                   pad):
    rng = np.random.default_rng(b + h + cin)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((size * size * cin, cout))
          / np.sqrt(size * size * cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.normal(0.0, 0.1, cout).astype(np.float32)
    want = jax_make_engine("xla").conv2d(
        jnp.asarray(x), jnp.asarray(wt), scale=jnp.asarray(scale),
        shift=jnp.asarray(shift), size=size, stride=stride, pad=pad,
        act="leaky")
    got = make_engine(backend, device="cpu").conv2d(
        torch.from_numpy(x), torch.from_numpy(wt),
        scale=torch.from_numpy(scale), shift=torch.from_numpy(shift),
        size=size, stride=stride, pad=pad, act="leaky")
    assert tuple(got.shape) == want.shape
    assert _relmax(got.numpy(), np.asarray(want)) <= FP32_TOL


@pytest.mark.parametrize("policy,tol", [("fp32_strict", FP32_TOL),
                                        ("mixed", 5e-2)])
def test_engine_matmul_matches_jax_with_leading_dims(policy, tol):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 24)) / 7).astype(np.float32)
    shift = rng.normal(0.0, 0.1, 24).astype(np.float32)
    want = jax_make_engine("xla", policy).matmul(
        jnp.asarray(x), jnp.asarray(w), shift=jnp.asarray(shift), act="silu")
    got = make_engine("eager", policy, device="cpu").matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        shift=torch.from_numpy(shift), act="silu")
    assert tuple(got.shape) == (2, 5, 24)
    assert got.dtype == Precision(policy).compute_dtype
    assert _relmax(got.float().numpy(),
                   np.asarray(want.astype(jnp.float32))) <= tol


# ----------------------------------------------------------------- layers ---

def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(8)
    g, bt, m, b = (rng.normal(1.0, 0.2, 32).astype(np.float32)
                   for _ in range(4))
    v = rng.uniform(0.1, 2.0, 32).astype(np.float32)
    want = jax_layers.fold_batchnorm(*map(jnp.asarray, (g, bt, m, v, b)))
    got = layers.fold_batchnorm(*map(torch.from_numpy, (g, bt, m, v, b)))
    for a, e in zip(got, want):
        assert _relmax(a.numpy(), np.asarray(e)) <= FP32_TOL


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("size,stride,pad", [(2, 2, 0), (3, 2, 1), (4, 2, 1)])
def test_deconv2d_matches_jax(size, stride, pad, bn):
    rng = np.random.default_rng(size * 10 + stride + pad)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    p = {"w": (rng.standard_normal((8, size * size * 4)) / 3)
         .astype(np.float32)}
    if bn:
        p.update(gamma=rng.uniform(0.5, 1.5, 4), beta=rng.normal(0, .1, 4),
                 mean=rng.normal(0, .1, 4), var=rng.uniform(0.5, 1.5, 4))
    else:
        p["b"] = rng.normal(0, .1, 4)
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    kw = dict(size=size, stride=stride, pad=pad, act="leaky",
              batch_normalize=bn)
    want = jax_layers.deconv2d(jax_make_engine("xla"),
                               {k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), **kw)
    got = layers.deconv2d(_eager(),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), **kw)
    assert tuple(got.shape) == want.shape
    assert _relmax(got.numpy(), np.asarray(want)) <= FP32_TOL


def _glue_cases():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32)
    y = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("op", ["maxpool", "maxpool_s1", "maxpool_pad",
                                "avgpool", "upsample", "route", "shortcut",
                                "connected", "softmax"])
def test_glue_layers_match_jax(op):
    x, y = _glue_cases()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if op == "maxpool":
        want = jax_layers.maxpool(jx, size=2, stride=2)
        got = layers.maxpool(tx, size=2, stride=2)
    elif op == "maxpool_s1":
        want = jax_layers.maxpool(jx, size=3, stride=1)
        got = layers.maxpool(tx, size=3, stride=1)
    elif op == "maxpool_pad":
        want = jax_layers.maxpool(jx, size=2, stride=1, pad=1)
        got = layers.maxpool(tx, size=2, stride=1, pad=1)
    elif op == "avgpool":
        want, got = jax_layers.avgpool_global(jx), layers.avgpool_global(tx)
    elif op == "upsample":
        want = jax_layers.upsample(jx, stride=2)
        got = layers.upsample(tx, stride=2)
    elif op == "route":
        want = jax_layers.route([jx, jy])
        got = layers.route([tx, ty])
    elif op == "shortcut":
        want = jax_layers.shortcut(jx, jx[..., ::-1], act="leaky")
        got = layers.shortcut(tx, tx.flip(-1), act="leaky")
    elif op == "connected":
        rng = np.random.default_rng(6)
        w = (rng.standard_normal((8 * 6 * 5, 7)) / 15).astype(np.float32)
        b = rng.normal(0, .1, 7).astype(np.float32)
        want = jax_layers.connected(jax_make_engine("xla"),
                                    {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                    jx, act="relu")
        got = layers.connected(_eager(), {"w": torch.from_numpy(w),
                                          "b": torch.from_numpy(b)},
                               tx, act="relu")
    else:
        want = jax_layers.softmax(jx.reshape(2, -1))
        got = layers.softmax(tx.reshape(2, -1))
    assert tuple(got.shape) == want.shape
    assert _relmax(got.numpy(), np.asarray(want)) <= FP32_TOL


# ---------------------------------------------------------------- compile ---

def test_compiled_network_captures_one_build_and_validates_input():
    tree = _jax_params(DARKNET_SMALL_CFG)
    net = Network(DARKNET_SMALL_CFG, _eager())
    net.load_state_dict(params_from_jax(tree))
    before = dispatch_counts()
    cn = net.compile(batch_size=2)
    assert cn.op_counts == {("eager", "conv2d"): 3, ("eager", "matmul"): 1}
    assert counts_since(before) == cn.op_counts
    assert cn.trace_count == 1
    assert [r["op"] for r in cn.op_log] == ["conv2d"] * 3 + ["matmul"]
    x = torch.from_numpy(_images(net, 2))
    with torch.inference_mode():
        want = net(x)
    np.testing.assert_array_equal(cn(x).numpy(), want.numpy())
    assert cn.warmup() is cn and cn.trace_count == 1
    prof = cn.profile(x, reps=1)
    assert prof["batch_size"] == 2 and prof["trace_count"] == 1
    assert prof["op_counts"] == cn.op_counts and prof["per_call_s"] > 0
    with pytest.raises(ValueError, match="compiled for input"):
        cn(x[:1])
    with pytest.raises(ValueError, match="dtype"):
        cn(x.double())


# --------------------------------------------------------------- registry ---

def test_registry_dispatches_counts_and_validates():
    from repro_torch.core import backends
    seen = []

    def probe_matmul(x, w, scale, shift, *, act, out_dtype, ctx):
        seen.append((tuple(x.shape), act, ctx.precision.policy, ctx.tiles))
        return torch.zeros(x.shape[0], w.shape[1], dtype=out_dtype)

    backends.register_backend("probe", {"matmul": probe_matmul},
                              overwrite=True)
    with pytest.raises(ValueError, match="already registered"):
        backends.register_backend("probe", {"matmul": probe_matmul})
    with pytest.raises(ValueError, match="unknown ops"):
        backends.register_backend("typo", {"matmull": probe_matmul})
    with pytest.raises(ValueError, match="unknown backend"):
        backends.get_backend("typo")
    eng = dataclasses.replace(_eager(), backend="probe")
    before, mark = dispatch_counts(), backends.dispatch_log_size()
    y = eng.matmul(torch.ones(2, 3, 4), torch.ones(4, 5), act="relu")
    assert tuple(y.shape) == (2, 3, 5)
    assert seen == [((6, 4), "relu", "fp32_strict", ())]
    assert counts_since(before) == {("probe", "matmul"): 1}
    assert backends.dispatch_log()[mark:] == [{
        "backend": "probe", "op": "matmul", "shapes": (6, 4, 5),
        "dtype": "torch.float32", "tiles": ()}]
    with pytest.raises(NotImplementedError, match="conv2d"):
        eng.conv2d(torch.ones(1, 3, 3, 1), torch.ones(9, 1), size=3)
    assert backends.get_backend("cuda").tiles(
        "conv2d", ((8, 224, 224, 3), 32, 3, 1, 1), torch.float32) == \
        ("B", 64, 32)
    assert backends.gemm_dims("conv2d", ((8, 224, 224, 3), 32, 3, 1, 1)) \
        == (8 * 224 * 224, 27, 32)
    assert Precision("mixed").param_dtype == torch.float32
    assert Precision("mixed").compute_dtype == torch.bfloat16
