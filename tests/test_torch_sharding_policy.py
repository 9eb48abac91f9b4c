"""`repro_torch.sharding.policy` against the JAX package's
`repro.sharding.policy`, in one process on the CPU.

For every config of `ARCH_IDS`, on the shape-only meshes {"data": 16,
"model": 16} and {"pod": 2, "data": 16, "model": 16}: `param_pspecs`
(fsdp off, fsdp on, strategy "fsdp") and `zero1_pspecs` tuple-equal to
JAX's, entry by entry (each spec read on the stacked leaf, as JAX's);
`needs_fsdp` at JAX's 16e9; `batch_pspecs` for every `input_specs` of
every `SHAPES` entry; `named`'s placements and `flat_specs`' map from the
port's flat names to the stacked leaves.  JAX's spec trees are computed
once per config, in a module fixture.
"""
import itertools
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jax_base
from repro.sharding import policy as jax_policy
from repro_torch.configs import base
from repro_torch.models import transformer as tfm
from repro_torch.sharding import policy
from repro_torch.tree import flatten

torch.set_num_threads(1)

MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}
MODES = {"tp": dict(fsdp=False), "tp_fsdp": dict(fsdp=True),
         "fsdp": dict(strategy="fsdp")}


def _jax_mesh(dims):
    return types.SimpleNamespace(shape=dims, axis_names=tuple(dims))


def _flat_jax(tree) -> dict:
    """{dotted path: spec tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[".".join(keys)] = tuple(spec)
    return out


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, tuple):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def jax_specs():
    """JAX's spec trees by (arch, mesh, mode), and zero1's by (arch,
    mesh)."""
    out = {}
    for arch in base.ARCH_IDS:
        cfg = jax_base.get_arch(arch)
        for mname, dims in MESHES.items():
            m = _jax_mesh(dims)
            for mode, kw in MODES.items():
                out[arch, mname, mode] = _flat_jax(
                    jax_policy.param_pspecs(cfg, m, **kw))
            out[arch, mname, "zero1"] = _flat_jax(
                jax_policy.zero1_pspecs(cfg, m))
    return out


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_param_and_zero1_specs_equal_the_jax_specs(jax_specs, arch, mname):
    cfg, dims = base.get_arch(arch), MESHES[mname]
    got = {mode: _flat(policy.param_pspecs(cfg, dims, **kw))
           for mode, kw in MODES.items()}
    got["zero1"] = _flat(policy.zero1_pspecs(cfg, dims))
    for mode, specs in got.items():
        want = jax_specs[arch, mname, mode]
        assert set(specs) == set(want), (mode, set(specs) ^ set(want))
        for path, spec in want.items():
            assert specs[path] == spec, (mode, path, specs[path], spec)


def test_fsdp_reads_the_stacked_leaf():
    """qwen2-0.5b's wk is (24, 896, 128) stacked, 114,688 values a layer:
    under the 2**20 threshold per layer, over it stacked, so it takes
    'data' as JAX's does."""
    cfg = base.get_arch("qwen2-0.5b")
    specs = policy.param_pspecs(cfg, MESHES["pod1"], fsdp=True)
    attn = specs["stacks"][0]["attn"]
    assert policy.stacked_shapes(cfg)["stacks"][0]["attn"]["wk"] == (
        24, 896, 128)
    assert attn["wk"] == (None, "data", "model")
    assert attn["wq"] == attn["wv"] == (None, "data", "model")
    assert attn["wo"] == (None, "model", "data")


def test_fsdp_strategy_can_shard_the_layer_dim():
    """Under strategy "fsdp" 'data' lands on the layer dim itself for
    mamba2-1.3b's conv_x (48, 4, 4096) and llama4-scout's router (48,
    5120, 16): no per-layer spec can say that."""
    mamba = policy.param_pspecs(base.get_arch("mamba2-1.3b"),
                                MESHES["pod1"], strategy="fsdp")
    assert mamba["stacks"][0]["mixer"]["conv_x"] == ("data", None, "model")
    scout = policy.param_pspecs(base.get_arch("llama4-scout-17b-a16e"),
                                MESHES["pod1"], strategy="fsdp")
    assert scout["stacks"][0]["moe"]["router"] == ("data", "model", None)


@pytest.mark.parametrize("mname", list(MESHES))
def test_needs_fsdp_equals_jax(mname):
    dims = MESHES[mname]
    for arch in base.ARCH_IDS:
        assert policy.needs_fsdp(base.get_arch(arch), dims, 16e9) == \
            jax_policy.needs_fsdp(jax_base.get_arch(arch), _jax_mesh(dims),
                                  16e9), arch


def test_needs_fsdp_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        policy.needs_fsdp(base.get_arch("qwen2-0.5b"), MESHES["pod1"])


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_batch_pspecs_equal_jax(mname, strategy):
    dims = MESHES[mname]
    for arch in base.ARCH_IDS:
        jcfg = jax_base.get_arch(arch)
        for shape in jax_base.SHAPES.values():
            specs = jax_base.input_specs(jcfg, shape)
            want = jax_policy.batch_pspecs(specs, _jax_mesh(dims), strategy)
            inputs = {k: torch.empty(v.shape, device="meta")
                      for k, v in specs.items()}
            got = policy.batch_pspecs(inputs, dims, strategy)
            assert got == {k: tuple(v) for k, v in want.items()}, (
                arch, shape.name)


def test_named_gives_one_placement_per_mesh_dim():
    spec_tree = {"a": ("data", None, "model"), "b": [(None,), (("pod",
                                                                 "data"),)]}
    got = policy.named(MESHES["pod2"], spec_tree)
    assert got["a"] == (Replicate(), Shard(0), Shard(2))
    assert got["b"][0] == (Replicate(),) * 3
    assert got["b"][1] == (Shard(0), Shard(0), Replicate())
    # a spec name absent from the mesh is a size-1 dim: replicated
    assert policy.placements({"data": 2}, (None, "model")) == (Replicate(),)
    assert policy.placements({"data": 2}, ("model", "data")) == (Shard(1),)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b",
                                  "deepseek-v2-lite-16b", "internvl2-2b"])
def test_flat_specs_map_every_port_name_to_its_stack(arch):
    cfg = base.reduced(base.get_arch(arch))
    tree = policy.param_pspecs(cfg, MESHES["pod1"], fsdp=True)
    flat = policy.flat_specs(cfg, tree)
    names = flatten(tfm.init_params(cfg, generator=None, device="meta"))
    assert list(flat) == list(names)
    specs, shapes = _flat(tree), _flat(policy.stacked_shapes(cfg))
    members = {}
    for name, leaf in flat.items():
        assert leaf.spec == specs[leaf.path]
        stacked = tuple(shapes[leaf.path])
        assert stacked[len(leaf.index):] == tuple(names[name].shape)
        members.setdefault(leaf.path, []).append(leaf.index)
    # every layer of every stack once, in row-major order
    for path, idx in members.items():
        lead = tuple(shapes[path])[:len(idx[0])]
        assert idx == list(itertools.product(*map(range, lead))), path
