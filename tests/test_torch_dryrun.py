"""The port's dry run and its memory accounting (`launch/dryrun.py`,
`serve/kvcache.py`'s specs and bytes, `PagedKVCache.pool_bytes`,
`configs.base`'s SHAPES / cell_supported / input_specs,
`analysis/roofline.py`) against the JAX package, on the CPU.

* For every arch of ARCH_IDS, every shape of SHAPES and both production
  meshes as {dim: size} mappings: `cell_supported`, `cache_bytes`,
  `kv_broadcast_bytes` and `cache_pspecs` (as tuples) equal JAX's, and
  `dryrun.memory_terms`' per-rank bytes of parameters, moments and
  caches equal the bytes of JAX's ``eval_shape(init_params)`` /
  ``cache_struct`` leaves under JAX's specs (at the cell's fsdp flag).
* `input_specs` has JAX's shapes; ids and pos are int64 where JAX's are
  int32 (a difference by design: PyTorch indexes with int64).
* `pool_bytes` equals JAX's on a reduced config, with and without the
  trash block; `model_flops_for` and `Roofline.to_dict`'s keys equal
  JAX's.
* `lower_cell`'s FLOPs on reduced dense, MoE, MLA, audio, vision, SSM
  and hybrid configs (prefill and train at 2 x 64) against JAX's
  `analysis/hlo_cost.analyze` dot FLOPs of the same step compiled on one
  CPU device.  Prefill is exact.  Train counts one head GEMM more than
  JAX, exactly 2 B S D V_padded: the port's chunked cross-entropy runs
  each chunk under ``torch.utils.checkpoint``, which recomputes the
  chunk's logits in the backward, where XLA keeps them.  The SSM and
  hybrid configs' SSD takes different einsum forms in the two packages
  (the port's `eager` chunked scan, JAX's `xla` one), so there the rest
  is held within 3 %.
* The full-width cell qwen2-0.5b x decode_32k on 16 x 16: `status` ok,
  0.403 GB of caches a rank as JAX shards them, 103.08 GB whole on every
  rank of the port, and a skipped cell gets JAX's skipped record.
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.analysis import hlo_cost
from repro.analysis import roofline as jax_roofline
from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.models import transformer as jax_tfm
from repro.serve import kvcache as jax_kvcache
from repro.serve import kvpool as jax_kvpool
from repro.serve.serve_step import make_forward_step as jax_forward_step
from repro.serve.serve_step import make_prefill_step as jax_prefill_step
from repro.sharding import policy as jax_policy
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.analysis import roofline
from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tfm
from repro_torch.serve import kvcache, kvpool
from repro_torch.sharding import policy

torch.set_num_threads(1)

MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s, m) for a in base.ARCH_IDS for s in base.SHAPES
         for m in MESHES]


def _jax_mesh(dims):
    return types.SimpleNamespace(shape=dims, axis_names=tuple(dims))


def _ranks(spec, dims) -> int:
    n = 1
    for s in spec:
        for a in ((s,) if isinstance(s, str) else (s or ())):
            n *= dims.get(a, 1)
    return n


def _jax_bytes(structs, specs, dims) -> int:
    """Per-rank bytes of JAX struct leaves under JAX's spec tree."""
    leaves = jax.tree_util.tree_leaves(structs)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               // _ranks(tuple(sp), dims)
               for x, sp in zip(leaves, spec_leaves))


def _jax_specs_flat(tree) -> list:
    return [tuple(sp) for sp in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _flat(tree) -> list:
    if isinstance(tree, tuple):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [x for v in tree for x in _flat(v)]


@functools.lru_cache(maxsize=None)
def _jax_structs(arch):
    """JAX's parameter structs of a config, at full size."""
    return jax.eval_shape(
        lambda k: jax_tfm.init_params(k, jax_base.get_arch(arch)),
        jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def jax_params(arch, mesh, fsdp) -> tuple[int, int]:
    """Per-rank bytes of JAX's parameters under its `param_pspecs` (at
    `fsdp`) and of its two AdamW moments under `zero1_pspecs`."""
    structs = _jax_structs(arch)
    dims = MESHES.get(mesh, {})
    if not dims:
        whole = _jax_bytes(structs, jax.tree.map(
            lambda x: PartitionSpec(), structs), {})
        return whole, 2 * whole
    jcfg, jm = jax_base.get_arch(arch), _jax_mesh(dims)
    return (_jax_bytes(structs, jax_policy.param_pspecs(jcfg, jm, fsdp=fsdp),
                       dims),
            2 * _jax_bytes(structs, jax_policy.zero1_pspecs(jcfg, jm), dims))


def test_shapes_and_arch_ids_are_jax_s():
    assert set(base.ARCH_IDS) == set(jax_base.ARCH_IDS)
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in base.SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind)
        for k, s in jax_base.SHAPES.items()}


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_cell_supported_and_input_specs_match_jax(arch):
    cfg, jcfg = base.get_arch(arch), jax_base.get_arch(arch)
    for name, shape in base.SHAPES.items():
        jshape = jax_base.SHAPES[name]
        assert base.cell_supported(cfg, shape) == \
            jax_base.cell_supported(jcfg, jshape)
        got, want = base.input_specs(cfg, shape), jax_base.input_specs(
            jcfg, jshape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            if want[k].dtype == jnp.int32:      # by design: int64 ids
                assert t.dtype == torch.int64
            else:
                assert want[k].dtype == jnp.float32
                assert t.dtype == torch.float32


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_bytes_and_cache_specs_match_jax(arch, shape, mesh):
    cfg, jcfg = base.get_arch(arch), jax_base.get_arch(arch)
    sh = base.SHAPES[shape]
    dims = MESHES[mesh]
    B, S = sh.global_batch, sh.seq_len
    assert kvcache.cache_bytes(cfg, B, S) == jax_kvcache.cache_bytes(
        jcfg, B, S)
    assert kvcache.kv_broadcast_bytes(cfg, B, S) == \
        jax_kvcache.kv_broadcast_bytes(jcfg, B, S)
    jm = _jax_mesh(dims)
    assert _flat(kvcache.cache_pspecs(cfg, dims, B, S)) == \
        _jax_specs_flat(jax_kvcache.cache_pspecs(jcfg, jm, B, S))
    fsdp = policy.needs_fsdp(cfg, dims, hbm_bytes=roofline.HW["hbm_bytes"])
    memory, port, _ = dryrun.memory_terms(cfg, sh, dims, fsdp=fsdp)
    params, moments = jax_params(arch, mesh, fsdp)
    assert memory["params"] == params
    assert port["params"] == jax_params(arch, "one_rank", False)[0]
    if sh.kind == "train":
        assert memory["moments"] == port["moments"] == moments
    else:
        assert memory["moments"] == port["moments"] == 0
    if sh.kind == "decode" and not cfg.is_encoder:
        structs = jax_kvcache.cache_struct(jcfg, B, S)
        assert memory["caches"] == _jax_bytes(
            structs, jax_kvcache.cache_pspecs(jcfg, jm, B, S), dims)
        assert port["caches"] == jax_kvcache.cache_bytes(jcfg, B, S)
    else:
        assert memory["caches"] == port["caches"] == 0
    for terms in (memory, port):
        assert terms["total"] == sum(terms[k] for k in dryrun.MEMORY_TERMS)


def test_cache_init_is_cache_struct_zeroed():
    cfg = base.reduced(base.get_arch("zamba2-7b"))
    struct = kvcache.cache_struct(cfg, 2, 16)
    init = kvcache.cache_init(cfg, 2, 16)

    def pairs(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            return [p for k in a for p in pairs(a[k], b[k])]
        if isinstance(a, list):
            return [p for x, y in zip(a, b) for p in pairs(x, y)]
        return [(a, b)]

    leaves = pairs(struct, init)
    assert leaves and all(
        s.device.type == "meta" and t.device.type == "cpu"
        and s.shape == t.shape and s.dtype == t.dtype and not t.any()
        for s, t in leaves)


@pytest.mark.parametrize("include_trash", [False, True])
def test_pool_bytes_matches_jax(include_trash):
    name = "qwen2-0.5b"
    cfg, jcfg = (base.reduced(base.get_arch(name)),
                 jax_base.reduced(jax_base.get_arch(name)))
    got = kvpool.PagedKVCache(cfg, 6, 8).pool_bytes(include_trash)
    want = jax_kvpool.PagedKVCache(jcfg, 6, 8).pool_bytes(include_trash)
    assert got == want
    assert got == (2 * cfg.n_layers * (6 + include_trash) * 8
                   * cfg.n_kv_heads * cfg.head_dim * 4)


def test_roofline_matches_jax_s_formulas():
    keys = jax_roofline.Roofline(1.0, 1.0, 1.0, "fp32", 1, 1.0).to_dict()
    assert set(roofline.Roofline(1.0, 1.0, 1.0, "fp32", 1,
                                 1.0).to_dict()) == set(keys)
    for arch in base.ARCH_IDS:
        cfg, jcfg = base.get_arch(arch), jax_base.get_arch(arch)
        total, active = tfm.param_counts(cfg)
        for name, shape in base.SHAPES.items():
            assert roofline.model_flops_for(cfg, shape, total, active) == \
                jax_roofline.model_flops_for(jcfg, jax_base.SHAPES[name],
                                             total, active)
    r = roofline.Roofline(67e12, 3.35e12, 0.0, "fp32", 1, 67e12)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_bound == pytest.approx(1.0)


def _jax_dot_flops(cfg, shape) -> float:
    eng = jax_make_engine("xla", "fp32_strict")
    params = jax.eval_shape(lambda k: jax_tfm.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    specs = jax_base.input_specs(cfg, shape)
    if shape.kind == "train":
        state = jax.eval_shape(jax_opt.adamw_init, params)
        step = jax_train_step(eng, cfg, jax_opt.AdamWConfig(),
                              ce_chunk=min(512, shape.seq_len))
        lowered = jax.jit(step).lower(params, state, specs)
    else:
        make = jax_forward_step if cfg.is_encoder else jax_prefill_step
        lowered = jax.jit(make(eng, cfg)).lower(params, specs)
    return hlo_cost.analyze(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", [
    "qwen2-0.5b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
    "hubert-xlarge", "internvl2-2b", "mamba2-1.3b", "zamba2-7b"])
def test_flops_match_jax_hlo_cost(arch, kind):
    b, s = 2, 64
    cfg = base.reduced(base.get_arch(arch))
    rec = dryrun.lower_cell(cfg, base.ShapeConfig("cell", s, b, kind),
                            mesh={})
    assert rec["status"] == "ok" and rec["chips"] == 1
    want = _jax_dot_flops(jax_base.reduced(jax_base.get_arch(arch)),
                          jax_base.ShapeConfig("cell", s, b, kind))
    got = rec["flops_total"]
    if kind == "train":   # the CE chunks' logits, recomputed
        got -= 2 * b * s * cfg.d_model * cfg.vocab_padded
    if cfg.is_ssm:
        assert abs(got - want) <= 0.03 * want, (got, want)
    else:
        assert got == want


def test_full_width_decode_cell_on_the_single_pod_mesh():
    rec = dryrun.lower_cell("qwen2-0.5b", "decode_32k")
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh"] == "single_pod"
    assert rec["memory"]["caches"] == 402_653_184          # 0.403 GB
    assert rec["memory_port"]["caches"] == 103_079_215_104  # 103.08 GB
    assert rec["fits"] is False
    assert rec["flops_per_chip"] == rec["flops_total"] / 256
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert all(r[k] > 0 for k in ("t_compute_s", "t_memory_s",
                                  "t_collective_s"))
    # every projection takes the row path, every attention the batch path
    assert rec["paths"] == {"matmul_rows": rec["dispatches"] - 24,
                            "attention_batch": 24}
    assert dryrun.lower_cell("qwen2-0.5b", "long_500k") == {
        "arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "single_pod",
        "status": "skipped", "reason": jax_base.cell_supported(
            jax_base.get_arch("qwen2-0.5b"), jax_base.SHAPES["long_500k"])[1]}
