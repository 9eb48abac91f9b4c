"""Training across a device mesh on two gloo ranks of the CPU, held
against the JAX package.

One spawn of two ranks (`launch.mesh.spawn`, a file store in tmp_path)
runs `repro_torch.launch.mesh_checks.train_check`:

* each sharded op's gradients (matmul rows with scale and shift, the bmm
  batch, the im2col conv2d, attention by batch and by KV-head group at a
  prefill shape) against the local wrapper's autograd in one process:
  bitwise for the sliced operands (q, k, v, x; a 2-row GEMM shard may sum
  in another order in the CPU's BLAS, held to 1e-6, as in
  tests/test_torch_sharded.py), within 1e-6 for the weights summed over
  the ranks (w, scale, shift: two partial dW added, against one);
* a decode-shaped attention under grad refused by name on the mesh;
* reduced qwen2-0.5b at 4 x 32 on ("data",) and on ("model",): the loss
  and every gradient against `jax.value_and_grad(tfm.loss_fn)` on `xla`
  at tests/test_torch_lm_train.py's bars (1e-5 relative, 1e-4
  max-relative); a rerun bit for bit;
* three `make_train_step` steps on ("data",) with replicated moments and
  with ZeRO-1 moments (`optimizer.zero1_init` by `zero1_pspecs`) against
  JAX's `make_train_step`, and the ZeRO-1 trajectory bit for bit the
  replicated one, the moments gathered; the ZeRO-1 moments half the size;
* one `make_cnn_train_step` step of DARKNET_SMALL_CFG on ("data",)
  against JAX's, at tests/test_torch_train.py's bars;
* both ranks' results bit for bit the same throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import darknet_ref as jax_cfgs
from repro.core import make_engine as jax_make_engine
from repro.core.darknet.network import Network as JaxNetwork
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as jax_tfm
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_cnn_train_step as jax_cnn_step
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.launch import mesh, mesh_checks

torch.set_num_threads(1)

DATA = ((2,), ("data",))
MODEL = ((2,), ("model",))
LOSS_TOL, TOL = 1e-5, 1e-4        # tests/test_torch_lm_train.py's bars
CNN_TOL, UPDATE_TOL = 1e-5, 1e-4  # tests/test_torch_train.py's
CPU_BLAS_TOL = 1e-6
B, S, CE_CHUNK = 4, 32, 16
OCFG = dict(lr=1e-3, warmup_steps=1, decay_steps=3)
STEPS = 3

OP_CASES = [
    dict(name="matmul_rows", op="matmul", m=16, k=96, n=40, act="silu",
         scale=True, shift=True, mesh=DATA, grad=True),
    dict(name="matmul_two_rows_head", op="matmul", m=4, k=64, n=96,
         trans=True, mesh=DATA, grad=True, tol=CPU_BLAS_TOL),
    dict(name="bmm_batch", op="bmm", b=4, m=6, k=32, n=16, mesh=DATA,
         grad=True),
    dict(name="conv2d", op="conv2d", b=2, h=9, w=9, cin=8, cout=16, size=3,
         pad=1, act="leaky", scale=True, shift=True, mesh=DATA, grad=True),
    dict(name="attention_batch", op="attention", b=4, sq=16, skv=48, h=4,
         kv=2, d=32, causal=True, kv_len=[48, 30, 16, 0], mesh=DATA,
         grad=True),
    dict(name="attention_heads_prefill", op="attention", b=2, sq=16,
         skv=16, h=8, kv=2, d=32, causal=True, kv_len=None, mesh=MODEL,
         grad=True),
]
REFUSED = dict(name="attention_decode_refused", op="attention", b=2, sq=1,
               skv=256, h=4, kv=2, d=32, causal=True, kv_len=[256, 77],
               mesh=DATA, grad=True)
# the operands whose gradients are summed over the ranks, not gathered
SUMMED = {"w", "scale", "shift"}
PATHS = {"matmul_rows": "matmul_rows", "matmul_two_rows_head": "matmul_rows",
         "bmm_batch": "bmm_batch", "conv2d": "matmul_rows",
         "attention_batch": "attention_batch",
         "attention_heads_prefill": "attention_heads"}
LM_RUNS = [dict(name="grad_data", mesh=DATA, rerun=True),
           dict(name="grad_model", mesh=MODEL),
           dict(name="steps_data", mesh=DATA, steps=STEPS),
           dict(name="zero1_data", mesh=DATA, steps=STEPS, zero1=True,
                same_as="steps_data"),
           # at this size zero1_pspecs shards no leaf under "tp" (none has
           # 2**20 elements); under "fsdp" it shards the embedding and the
           # MLP weights; "layers" gives each rank whole layers' moments
           dict(name="zero1_fsdp", mesh=DATA, strategy="fsdp", steps=STEPS,
                zero1=True, same_as="steps_data"),
           dict(name="zero1_layers", mesh=DATA, steps=STEPS, zero1="layers",
                same_as="steps_data")]


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _assert_close(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    for name, w in want.items():
        err = _relmax(got[name], w)
        assert err <= tol, f"{what} {name}: {err:.3e} > {tol:g}"


def _lm_jax():
    """Reduced qwen2-0.5b's JAX parameters (random QKV biases), loss and
    gradients on 4 x 32, and three JAX train steps."""
    cfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    params = jax_tfm.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    stack = params["stacks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        stack[name] = jnp.asarray(
            rng.standard_normal(stack[name].shape).astype(np.float32) * 0.1)
    data = JaxSyntheticLM(cfg, jax_base.ShapeConfig("t", S, B, "train"),
                          seed=3)
    eng = jax_make_engine("xla", "fp32_strict")
    batch0 = jax.tree_util.tree_map(jnp.asarray, data.batch(0))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_tfm.loss_fn(eng, cfg, p, batch0, ce_chunk=CE_CHUNK)))(
        params)
    step = jax.jit(jax_make_train_step(eng, cfg, jax_opt.AdamWConfig(**OCFG),
                                       ce_chunk=CE_CHUNK))
    p, st, metrics = params, jax_opt.adamw_init(params), []
    for i in range(STEPS):
        p, st, m = step(p, st, jax.tree_util.tree_map(jnp.asarray,
                                                      data.batch(i)))
        metrics.append({k: float(v) for k, v in m.items()})
    host = jax.tree_util.tree_map(np.asarray, params)
    return host, {"loss": float(loss), "grads": _flat(grads),
                  "params": _flat(p), "mu": _flat(st["mu"]),
                  "nu": _flat(st["nu"]), "metrics": metrics}


def _cnn_jax():
    """DARKNET_SMALL_CFG's JAX parameters (BN statistics drawn away from
    1 / 0), a batch of 4, and one JAX train step."""
    net = JaxNetwork(jax_cfgs.DARKNET_SMALL_CFG, jax_make_engine("xla"))
    rng = np.random.default_rng(4)
    tree = {}
    for layer, leaves in jax.tree_util.tree_map(
            np.asarray, net.init(jax.random.PRNGKey(4))).items():
        tree[layer] = {}
        for name, v in leaves.items():
            v = np.asarray(v, np.float32)
            if name in ("gamma", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif name in ("beta", "mean", "b"):
                v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            tree[layer][name] = v
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, *net.in_shape)).astype(np.float32)
    labels = rng.integers(0, net.out_shape[-1], 4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jax_opt.adamw_init(params)
    p, st, m = jax_cnn_step(net, jax_opt.AdamWConfig(**OCFG))(
        params, state, (jnp.asarray(x), jnp.asarray(labels)))
    return tree, x, labels, {"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "params": _flat(p), "mu": _flat(st["mu"]),
                             "nu": _flat(st["nu"])}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    lm_params, lm_want = _lm_jax()
    cnn_params, x, labels, cnn_want = _cnn_jax()
    spec = dict(ocfg=OCFG, arrays=True, ops=OP_CASES + [REFUSED],
                ops_seed=12,
                lm=[dict(arch="qwen2-0.5b", reduced=True, params=lm_params,
                         batch=(B, S), data_seed=3, ce_chunk=CE_CHUNK,
                         runs=LM_RUNS)],
                cnn=[dict(cfg=DARKNET_SMALL_CFG, name="darknet_small",
                          params=cnn_params, batch=4, images=x,
                          labels=labels, runs=[dict(name="cnn_data",
                                                    mesh=DATA)])])
    store = tmp_path_factory.mktemp("train") / "store"
    ranks = mesh.spawn(mesh_checks.train_check, 2, "cpu", spec,
                       device_type="cpu", store_path=store, timeout=300)
    return ranks, lm_want, cnn_want


def _runs(rank, kind="lm"):
    return {r["name"]: r for r in rank[kind][0]["runs"]}


def test_both_ranks_agree_bit_for_bit(trained):
    (r0, r1), _, _ = trained
    assert r0["ops"] == r1["ops"]
    for kind in ("lm", "cnn"):
        a, b = _runs(r0, kind), _runs(r1, kind)
        assert set(a) == set(b)
        for name in a:
            assert a[name]["digest"] == b[name]["digest"], name
            assert a[name]["losses"] == b[name]["losses"], name
            for key, tree in a[name]["arrays"].items():
                got, other = _flat(tree), _flat(b[name]["arrays"][key])
                assert all(np.array_equal(v, other[k])
                           for k, v in got.items()), (name, key)


@pytest.mark.parametrize("i", range(len(OP_CASES)),
                         ids=[c["name"] for c in OP_CASES])
def test_op_gradients_against_the_local_wrapper(trained, i):
    case, res = OP_CASES[i], trained[0][0]["ops"][i]
    assert res["name"] == case["name"]
    assert list(res["paths"]) == [PATHS[case["name"]]], res["paths"]
    if case.get("tol"):
        assert res["relmax"] <= case["tol"], res
    else:
        assert res["bitwise"], res
    grads = res["grads"]
    want = ({"q", "k", "v"} if case["op"] == "attention" else
            {"x", "w"} | {k for k in ("scale", "shift") if case.get(k)})
    assert set(grads) == want, grads
    for name, g in grads.items():
        if name in SUMMED and case["op"] != "bmm":
            assert g["relmax"] <= CPU_BLAS_TOL, (name, g)
        elif case.get("tol"):
            assert g["relmax"] <= case["tol"], (name, g)
        else:
            assert g["bitwise"], (name, g)
        assert g["plain_relmax"] <= CPU_BLAS_TOL, (name, g)
    col = res["grad_collectives"]
    summed = sum(1 for k in grads if k in SUMMED and case["op"] != "bmm")
    assert col["sum"] == summed, col
    # forward: one gather of the output; backward: one per sliced operand
    sliced = len(grads) - summed
    assert col["all_gather"] == 1 + sliced, col
    assert col["to_host"] == 0                     # host tensors: no copy


def test_decode_shaped_attention_under_grad_is_refused_by_name(trained):
    res = trained[0][0]["ops"][len(OP_CASES)]
    assert res["name"] == REFUSED["name"]
    assert "'attention' on backend 'sharded_cuda'" in res["refused"]
    assert "inference only" in res["refused"]


@pytest.mark.parametrize("name,path", [("grad_data", "attention_batch"),
                                       ("grad_model", "attention_heads")])
def test_reduced_qwen2_loss_and_gradients_match_jax(trained, name, path):
    (r0, _), want, _ = trained
    run = _runs(r0)[name]
    assert abs(run["losses"][0] - want["loss"]) <= LOSS_TOL * abs(
        want["loss"])
    got = _flat(run["arrays"]["grads"])
    assert set(got) == set(want["grads"])
    for key, w in want["grads"].items():
        assert _relmax(got[key], w) <= TOL, key
    assert run["paths"].get(path, 0) > 0, run["paths"]
    assert all(k.startswith("sharded_cuda.") for k in run["dispatch"])
    if name == "grad_data":
        assert run["paths"].get("matmul_rows", 0) > 0
        assert run["collectives"]["sum"] > 0
        assert run["rerun_bitwise"]


@pytest.mark.parametrize("name", ["steps_data", "zero1_data", "zero1_fsdp",
                                  "zero1_layers"])
def test_three_mesh_steps_match_the_jax_step(trained, name):
    (r0, _), want, _ = trained
    run = _runs(r0)[name]
    for i, m in enumerate(want["metrics"]):
        assert abs(run["losses"][i] - m["loss"]) <= LOSS_TOL * abs(
            m["loss"]), f"step {i + 1} loss"
        assert abs(run["grad_norms"][i] - m["grad_norm"]) <= TOL * m[
            "grad_norm"]
        assert abs(run["lrs"][i] - m["lr"]) <= 1e-6 * m["lr"]
    for key in ("params", "mu", "nu"):
        _assert_close(run["arrays"][key], want[key], TOL, key)


@pytest.mark.parametrize("name", ["zero1_data", "zero1_fsdp",
                                  "zero1_layers"])
def test_zero1_steps_are_the_replicated_steps_bit_for_bit(trained, name):
    (r0, r1), _, _ = trained
    runs = _runs(r0)
    assert runs[name]["bitwise_same_as"] and _runs(r1)[name][
        "bitwise_same_as"]
    assert runs[name]["digest"] == runs["steps_data"]["digest"]
    replicated = runs["steps_data"]["moment_gb"]
    if name == "zero1_data":       # no leaf of 2**20 elements at this size
        assert runs[name]["moment_gb"] == replicated
    elif name == "zero1_fsdp":     # every leaf of 65536 elements halved
        assert 0.5 * replicated < runs[name]["moment_gb"] < replicated
    else:                          # every stacked leaf halved
        top = runs[name]["moment_gb"] - 0.5 * replicated
        assert 0 < top < 0.5 * replicated


def test_darknet_step_on_a_mesh_matches_the_jax_step(trained):
    (r0, _), _, want = trained
    run = _runs(r0, "cnn")["cnn_data"]
    assert _relmax(run["losses"][1], want["loss"]) <= CNN_TOL
    assert _relmax(run["grad_norms"][0], want["grad_norm"]) <= CNN_TOL
    for key in ("params", "mu", "nu"):
        _assert_close(run["arrays"][key], want[key], UPDATE_TOL, key)
    assert run["paths"] == {"matmul_rows": run["paths"]["matmul_rows"]}
    assert run["collectives"]["sum"] > 0
