"""The `sharded_cuda` backend on two gloo ranks of the CPU.

Two spawns of two ranks (`launch.mesh.spawn`, a file store in tmp_path),
the per-rank work in `repro_torch.launch.mesh_checks`:

* the sharded ops against the local wrappers on the same operands
  (`check_ops`): row-sharded `matmul`, `bmm` and im2col `conv2d` and
  batch-sharded attention bit for bit; head-sharded attention (mesh
  ("model",), strategy "tp", KV 2) and the sequence split (kv_len None and
  (3, 300) at Sq 1 and 4 over 512 keys, in one process against the spans'
  partials merged by `combine`, bit for bit) within 1e-5; the per-shard
  plan keys carry the shard's rows or batch;
* reduced qwen2-0.5b on the port's slot and paged engines under a mesh
  (`serve_streams`), on the JAX parameters carried by `convert`, against
  the streams of the JAX package's unsharded `ServingEngine` /
  `PagedServingEngine`: the batch, heads and sequence-split paths.

On the CPU each wrapper runs its plain version per shard.  A GEMM shard of
one or two rows (and a transposed weight) takes another summation order in
the CPU's BLAS than the whole matrix does, so those cases are held to 1e-6
max-relative; on the card the kernels keep every bit at any row count
(``chip_smoke.py``'s phase `check_sharded`).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.models import transformer as jax_tfm
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.serve.scheduler import PagedServingEngine as JaxPagedEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import make_engine
from repro_torch.launch import mesh, mesh_checks
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

DATA = ((2,), ("data",))
MODEL = ((2,), ("model",))
TOL = 1e-5
CPU_BLAS_TOL = 1e-6
MARGIN = 1e-3
PAGED = dict(kv_blocks=8, block_size=8, max_len=32, chunk=4,
             batch_buckets=(1, 2, 4))

CASES = [
    dict(name="matmul_rows", op="matmul", m=16, k=96, n=40, act="silu",
         shift=True, mesh=DATA, bits=True),
    dict(name="matmul_rows_scale", op="matmul", m=8, k=64, n=24, act="relu",
         scale=True, shift=True, mesh=DATA, bits=True),
    dict(name="matmul_two_rows_head", op="matmul", m=4, k=64, n=96,
         trans=True, mesh=DATA, tol=CPU_BLAS_TOL),
    dict(name="matmul_odd_rows", op="matmul", m=5, k=32, n=16, mesh=DATA,
         bits=True, path="matmul_local"),
    dict(name="bmm", op="bmm", b=4, m=6, k=32, n=16, mesh=DATA, bits=True),
    dict(name="conv2d", op="conv2d", b=2, h=9, w=9, cin=8, cout=16, size=3,
         pad=1, act="leaky", scale=True, shift=True, mesh=DATA, bits=True,
         path="matmul_rows"),
    dict(name="attention_batch", op="attention", b=4, sq=16, skv=48, h=4,
         kv=2, d=32, causal=True, kv_len=[48, 30, 16, 0], mesh=DATA,
         bits=True),
    dict(name="attention_batch_decode", op="attention", b=2, sq=1, skv=256,
         h=4, kv=2, d=32, causal=True, kv_len=[256, 77], mesh=DATA,
         bits=True),
    dict(name="attention_heads", op="attention", b=1, sq=4, skv=300, h=4,
         kv=2, d=32, causal=True, kv_len=[290], mesh=MODEL, tol=TOL),
    dict(name="attention_heads_prefill", op="attention", b=2, sq=16,
         skv=16, h=8, kv=2, d=32, causal=True, kv_len=None, mesh=MODEL,
         tol=TOL),
    *(dict(name=f"attention_seq_sq{sq}_{'none' if lens is None else 'lens'}",
           op="attention", b=2, sq=sq, skv=512, h=4, kv=1, d=32, causal=True,
           kv_len=lens, mesh=MODEL, tol=TOL, path="attention_seq")
      for sq in (1, 4) for lens in (None, [3, 300])),
    dict(name="attention_seq_batch3", op="attention", b=3, sq=4, skv=512,
         h=4, kv=2, d=32, causal=True, kv_len=[3, 300, 512], mesh=DATA,
         tol=TOL, path="attention_seq"),
]


@pytest.fixture(scope="module")
def op_results(tmp_path_factory):
    store = tmp_path_factory.mktemp("ops") / "store"
    ranks = mesh.spawn(mesh_checks.check_ops, 2, "cpu", CASES, 11,
                       device_type="cpu", store_path=store, timeout=300)
    return ranks


def test_both_ranks_compute_the_same(op_results):
    r0, r1 = op_results
    assert len(r0) == len(r1) == len(CASES)
    for a, b in zip(r0, r1):
        assert {k: v for k, v in a.items() if k != "keys"} == {
            k: v for k, v in b.items() if k != "keys"}, a["name"]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_sharded_op_against_the_local_wrapper(op_results, i):
    case, res = CASES[i], op_results[0][i]
    path = case.get("path", {"matmul": "matmul_rows", "bmm": "bmm_batch"}.get(
        case["op"], "attention_" + ("heads" if case["mesh"] == MODEL
                                    else "batch")))
    assert list(res["paths"]) == [path], res["paths"]
    gathers = res["collectives"]["all_gather"]
    assert gathers == (0 if path.endswith("local") else 1)
    assert res["collectives"]["to_host"] == 0       # host tensors: no copy
    if case.get("bits"):
        assert res["bitwise"], res
    else:
        assert res["relmax"] <= case["tol"], res
    assert res["plain_relmax"] <= case.get("tol", 0.0), res
    if path == "attention_seq":
        assert res["loop_bitwise"], res


def _keys(res, op):
    return [json.loads(k)[1] for k in res["keys"]
            if json.loads(k)[0] == op]


def test_per_shard_plan_keys_carry_the_shards_rows_and_batch(op_results):
    by_name = {c["name"]: r for c, r in zip(CASES, op_results[0])}
    assert _keys(by_name["matmul_rows"], "matmul") == [[8, 96, 40]]
    assert _keys(by_name["bmm"], "bmm") == [[2, 6, 32, 16]]
    # conv2d's im2col rows: 2 x 9 x 9 = 162 patch rows, 81 a shard
    assert _keys(by_name["conv2d"], "matmul") == [[81, 72, 16]]
    assert _keys(by_name["attention_batch"], "attention") == [
        [[2, 16, 4, 32], [2, 48, 2, 32]]]
    assert _keys(by_name["attention_heads_prefill"], "attention") == [
        [[2, 16, 4, 32], [2, 16, 1, 32]]]
    # a decode-shaped shard takes the split-KV kernel's key
    assert _keys(by_name["attention_batch_decode"], "attention_decode") == [
        [[1, 1, 4, 32], [1, 256, 2, 32]]]
    # each rank's span of the sequence split: 256 of the 512 keys
    assert _keys(by_name["attention_seq_sq4_lens"], "attention") == [
        [[2, 4, 4, 32], [2, 256, 1, 32]]]


# ------------------------------------------------------------ serving ---

def _jax_requests(cfg, n, seed, prompt_hi=12, new_hi=7):
    rng = np.random.default_rng(seed)
    return [JaxRequest(rid=i, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(2, prompt_hi))).tolist(),
        max_new=int(rng.integers(2, new_hi))) for i in range(n)]


def _min_margin(cfg, params, reqs) -> float:
    """Smallest teacher-forced top-2 logit margin over the emitted tokens,
    on the port's `eager` engine (JAX's logits within 1e-4,
    tests/test_torch_lm.py; a JAX trace a prompt length would take most of
    this file's time)."""
    eng = make_engine("eager", device="cpu")
    out = []
    with torch.inference_mode():
        for r in reqs:
            h, _ = tfm.forward_hidden(eng, cfg, params, tokens=torch.tensor(
                [r.prompt + r.out[:-1]]))
            rows = (h[0, len(r.prompt) - 1:] @ tfm.head_weight(params, cfg)
                    )[:, :cfg.vocab_size]
            top2 = torch.topk(rows, 2).values
            assert torch.equal(rows.argmax(-1), torch.tensor(r.out))
            out.append(float((top2[:, 0] - top2[:, 1]).min()))
    return min(out)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    params = jax_tfm.init_params(jax.random.PRNGKey(0), cfg)
    eng = jax_make_engine("xla", "fp32_strict")
    slot, seq = dict(slots=2, max_len=32), dict(slots=3, max_len=512)
    streams = {}                # (engine, seed) -> the JAX requests served
    for engine, kwargs, seed in (("slot", slot, 0), ("slot", seq, 1),
                                 ("paged", PAGED, 0)):
        reqs = _jax_requests(cfg, 6 if seed == 0 else 4, seed)
        cls = JaxPagedEngine if engine == "paged" else JaxServingEngine
        cls(cfg, params, engine=eng, **kwargs).run(reqs)
        streams[engine, seed] = reqs
    tree = jax.tree_util.tree_map(np.asarray, params)
    pcfg = base.reduced(base.get_arch("qwen2-0.5b"))
    assert _min_margin(pcfg, convert.lm_params_from_jax(tree, pcfg),
                       streams["slot", 0] + streams["slot", 1]) > MARGIN
    assert [r.out for r in streams["paged", 0]] == [
        r.out for r in streams["slot", 0]]
    runs, want = [], {}
    for name, engine, mesh_spec, kwargs, seed in (
            ("slot_batch", "slot", DATA, slot, 0),
            ("slot_heads", "slot", MODEL, slot, 0),
            ("slot_seq", "slot", DATA, seq, 1),
            ("paged_batch", "paged", DATA, PAGED, 0)):
        reqs = streams[engine, seed]
        want[name] = [r.out for r in reqs]
        runs.append(dict(name=name, engine=engine, mesh=mesh_spec,
                         kwargs=kwargs, requests=[(r.prompt, r.max_new)
                                                  for r in reqs]))
    spec = dict(arch="qwen2-0.5b", reduced=True, runs=runs, params=tree)
    store = tmp_path_factory.mktemp("serve") / "store"
    ranks = mesh.spawn(mesh_checks.serve_streams, 2, "cpu", spec,
                       device_type="cpu", store_path=store, timeout=300)
    return want, ranks


@pytest.mark.parametrize("name,path,dim", [
    ("slot_batch", "attention_batch", "data"),
    ("slot_heads", "attention_heads", "model"),
    ("slot_seq", "attention_seq", "data"),
    ("paged_batch", "attention_batch", "data")])
def test_engines_under_a_mesh_give_the_jax_streams(served, name, path, dim):
    want, ranks = served
    assert ranks[0]["checksums"][0] == ranks[0]["checksums"][1]
    runs = [{r["name"]: r for r in rank["runs"]} for rank in ranks]
    got = runs[0][name]
    assert got["done"] and got["streams"] == want[name]
    assert runs[1][name]["streams"] == want[name]
    assert got["mesh"] == [[dim, 2]]
    assert got["paths"].get(path, 0) > 0, got["paths"]
    assert all(key.startswith("sharded_cuda.") for key in got["dispatch"])
    if name == "paged_batch":
        # the step cache's dispatch keys carry the mesh topology
        assert all(json.loads(k)[0] == ["data", 2]
                   for k in got["compile_keys"])
