"""Sharding hints, meshes, the topology-keyed step cache and the
`sharded_cuda` backend in one process, on the CPU.

* `sharding.hints` off-mesh, and `resolve` under "tp" / "fsdp" against the
  JAX package's `batch_axes()` table;
* `mesh_topology`, `use_mesh(None)`, `launch.mesh.dp_size` (against JAX's
  on the same dims) and the production meshes refused by name off their
  world size;
* `StepCompileCache(topology=...)`, mirroring the JAX package's
  `test_compile_cache_topology_extends_keys` / `_off_mesh_keys_unchanged`;
* `sharded_cuda` registered with the full op set, every op differentiable
  and no tile hooks, bitwise the local wrappers off-mesh and on a one-rank
  mesh, defaulting to the card; off-mesh under grad every op's gradients
  bitwise the local wrapper's (`ssd` through its einsum form, counted),
  and a decode-shaped attention refused by name.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import mesh as jax_mesh
from repro.sharding import hints as jax_hints
from repro_torch.core import OP_SET, StepCompileCache, backends, make_engine
from repro_torch.kernels import ops, sharded
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.launch import mesh
from repro_torch.sharding import hints

torch.set_num_threads(1)

CPU = make_engine("sharded_cuda", device="cpu")


def _mesh(**dims):
    """A stand-in with a DeviceMesh's names and shape (hints read only
    those)."""
    return types.SimpleNamespace(mesh_dim_names=tuple(dims),
                                 shape=tuple(dims.values()))


def test_hints_are_no_ops_off_mesh():
    x = torch.ones(2, 3)
    assert hints.physical_mesh() is None and not hints.mesh_active()
    assert hints.mesh_topology() == ()
    assert hints.shard(x, "dp", None) is x
    assert hints.pspec("dp", "model", None) == (None, None, None)
    assert [hints.resolve(t) for t in ("dp", "model", None)] == [None] * 3
    assert sharded.mesh_plan() is None


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("dims", [("data",), ("model",), ("data", "model"),
                                  ("pod", "data", "model")])
def test_resolve_against_the_jax_batch_axes(strategy, dims):
    with jax_hints.strategy(strategy):
        jax_batch = jax_hints.batch_axes()
    m = _mesh(**{a: 2 for a in dims})
    with hints.strategy(strategy), hints.use_mesh(m):
        assert hints.current_strategy() == strategy
        assert hints.batch_axes() == jax_batch
        assert hints.physical_mesh() is m and hints.mesh_active()
        dp = tuple(a for a in jax_batch if a in dims) or None
        assert hints.resolve("dp") == dp
        model = ("model" if strategy == "tp" and "model" in dims else None)
        assert hints.resolve("model") == model
        assert hints.resolve("data") == ("data" if "data" in dims else None)
        assert hints.pspec("dp", None, "model") == (dp, None, model)
        x = torch.zeros(4)
        assert hints.shard(x, "dp") is x
    assert hints.current_strategy() == "tp" and hints.physical_mesh() is None
    with pytest.raises(ValueError, match="strategy"):
        with hints.strategy("zero"):
            pass


def test_mesh_topology_use_mesh_none_and_dp_size():
    m = _mesh(pod=2, data=16, model=16)
    assert hints.mesh_topology(m) == (("pod", 2), ("data", 16),
                                      ("model", 16))
    with hints.use_mesh(None) as got:
        assert got is None and hints.physical_mesh() is None
    with hints.use_mesh(m):
        assert hints.mesh_topology() == hints.mesh_topology(m)
        with hints.use_mesh(None):          # a null context: m stays
            assert hints.physical_mesh() is m
        with mesh.set_mesh(_mesh(data=2)):
            assert hints.mesh_topology() == (("data", 2),)
        assert hints.physical_mesh() is m
    for dims in ({"data": 4, "model": 2}, {"pod": 2, "data": 16, "model": 16},
                 {"model": 8}):
        jm = types.SimpleNamespace(shape=dims, axis_names=tuple(dims))
        assert mesh.dp_size(_mesh(**dims)) == jax_mesh.dp_size(jm)


def test_production_mesh_needs_its_world_size():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"needs 256 ranks"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match=r"needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh((2,), ("data",), device_type="cpu")
    with pytest.raises(ValueError, match="dim names"):
        mesh.make_mesh((2, 2), ("data",), device_type="cpu")


def test_compile_cache_topology_extends_keys():
    calls = []

    def step(x):
        calls.append(1)
        return x + 1

    topo = (("data", 8),)
    c = StepCompileCache(step, name="s", topology=topo)
    c(torch.zeros(2))
    c(torch.zeros(2))
    assert c.traces == 1 and c.calls == 2 and len(calls) == 2
    c.record((2, 1))
    assert c.stats()["topology"] == topo
    assert c.stats()["dispatches"] == {(("data", 8), 2, 1): 1}
    # another topology owns its own builds
    c.topology = (("data", 4),)
    c(torch.zeros(2))
    assert c.traces == 2


def test_compile_cache_off_mesh_keys_unchanged():
    c = StepCompileCache(lambda x: x, name="s")
    c.record((1, 2, 3))
    assert c.stats()["dispatches"] == {(1, 2, 3): 1}
    assert c.stats()["topology"] == ()


def test_backend_registered_with_the_full_op_set():
    be = backends.get_backend("sharded_cuda")
    assert set(be.ops) == set(OP_SET)
    assert be.differentiable == frozenset(OP_SET)
    assert be.inference_only is backends.decode_inference_only
    # no tile hooks: plans resolve from the per-shard shapes inside
    assert be.tiles("matmul", (64, 64, 64), "float32") == ()
    assert be.tile_candidates is None and be.tile_bench is None


def test_the_backend_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("sharded_cuda")
    assert make_engine("sharded_cuda", device="cpu").device.type == "cpu"


def _operands(seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g)

    return {"x": r(6, 48), "w": r(48, 20), "scale": r(20), "shift": r(20),
            "bx": r(4, 5, 24), "bw": r(4, 24, 7), "img": r(2, 7, 7, 4),
            "cw": r(36, 8), "q": r(2, 4, 4, 32), "k": r(2, 64, 2, 32),
            "v": r(2, 64, 2, 32), "dq": r(2, 1, 4, 32), "dk": r(2, 256, 2, 32),
            "dv": r(2, 256, 2, 32), "sx": r(2, 40, 4, 8), "sdt": r(2, 40, 4),
            "sA": -r(4).abs(), "sB": r(2, 40, 1, 16), "sC": r(2, 40, 1, 16),
            "ex": r(2, 3, 4, 24), "ey": r(3, 24, 10)}


def _local(a):
    kvl = torch.tensor([64, 20], dtype=torch.int32)
    dkvl = torch.tensor([256, 101], dtype=torch.int32)

    def mm(x, w, scale, shift, *, act, out_dtype, ctx):
        return ops.matmul(x, w, scale, shift, act=act, out_dtype=out_dtype)

    return [
        ops.matmul(a["x"], a["w"], a["scale"], a["shift"], act="silu"),
        ops.bmm(a["bx"], a["bw"]),
        backends.im2col_conv2d(mm)(a["img"], a["cw"], None, a["shift"][:8],
                                   size=3, stride=1, pad=1, act="leaky",
                                   out_dtype=torch.float32, ctx=None),
        ops.attention(a["q"], a["k"], a["v"], kvl, causal=True),
        ops.attention_decode(a["dq"], a["dk"], a["dv"], dkvl, causal=True),
        *ops.ssd(a["sx"], a["sdt"], a["sA"], a["sB"], a["sC"], chunk=16),
        backends.einsum_as_bmm("becd,edf->becf", a["ex"], a["ey"],
                               acc_dtype=torch.float32,
                               out_dtype=torch.float32)]


def _engine(a, eng=CPU):
    kvl = torch.tensor([64, 20], dtype=torch.int32)
    dkvl = torch.tensor([256, 101], dtype=torch.int32)
    return [
        eng.matmul(a["x"], a["w"], scale=a["scale"], shift=a["shift"],
                   act="silu"),
        eng.bmm(a["bx"], a["bw"]),
        eng.conv2d(a["img"], a["cw"], shift=a["shift"][:8], size=3, pad=1,
                   act="leaky"),
        eng.attention(a["q"], a["k"], a["v"], causal=True, kv_len=kvl),
        eng.attention(a["dq"], a["dk"], a["dv"], causal=True, kv_len=dkvl),
        *eng.ssd(a["sx"], a["sdt"], a["sA"], a["sB"], a["sC"], chunk=16),
        eng.einsum("becd,edf->becf", a["ex"], a["ey"])]


def test_off_mesh_every_op_is_the_local_wrapper_bitwise():
    a = _operands()
    sharded.reset_collectives()
    got, want = _engine(a), _local(a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    paths = sharded.path_counts()
    assert paths["matmul_local"] == 2 and paths["attention_local"] == 2
    assert sharded.collective_counts()["all_gather"] == 0


def test_a_one_rank_mesh_takes_the_local_path(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        m = mesh.make_mesh((1,), ("data",), device_type="cpu")
        assert hints.mesh_topology(m) == (("data", 1),)
        a = _operands(1)
        sharded.reset_collectives()
        with hints.use_mesh(m):
            assert sharded.mesh_plan() is None
            got = _engine(a)
        assert all(torch.equal(g, w) for g, w in zip(got, _local(a)))
        assert sharded.collective_counts()["all_gather"] == 0
    finally:
        dist.destroy_process_group()


EAGER = make_engine("eager", device="cpu")


def _grad_calls(a, eng, local: bool):
    """Each op of `OP_SET` on `a` through `eng`, or (`local`) the wrapper
    the sharded op falls back to off-mesh."""
    def mm(x, w, scale, shift, *, act, out_dtype, ctx):
        return ops.matmul(x, w, scale, shift, act=act, out_dtype=out_dtype)

    if not local:
        return {
            "matmul": lambda: eng.matmul(a["x"], a["w"], scale=a["scale"],
                                         shift=a["shift"], act="silu"),
            "bmm": lambda: eng.bmm(a["bx"], a["bw"]),
            "conv2d": lambda: eng.conv2d(a["img"], a["cw"],
                                         shift=a["shift"][:8], size=3,
                                         pad=1, act="leaky"),
            "attention": lambda: eng.attention(a["q"], a["k"], a["v"],
                                               causal=True),
            "ssd": lambda: eng.ssd(a["sx"], a["sdt"], a["sA"], a["sB"],
                                   a["sC"], chunk=16)[0],
            "einsum": lambda: eng.einsum("becd,edf->becf", a["ex"],
                                         a["ey"])}
    return {
        "matmul": lambda: ops.matmul(a["x"], a["w"], a["scale"], a["shift"],
                                     act="silu"),
        "bmm": lambda: ops.bmm(a["bx"], a["bw"]),
        "conv2d": lambda: backends.im2col_conv2d(mm)(
            a["img"], a["cw"], None, a["shift"][:8], size=3, stride=1,
            pad=1, act="leaky", out_dtype=torch.float32, ctx=None),
        "attention": lambda: ops.attention(a["q"], a["k"], a["v"],
                                           causal=True),
        "ssd": lambda: EAGER.ssd(a["sx"], a["sdt"], a["sA"], a["sB"],
                                 a["sC"], chunk=16)[0],
        "einsum": lambda: backends.einsum_as_bmm(
            "becd,edf->becf", a["ex"], a["ey"], acc_dtype=torch.float32,
            out_dtype=torch.float32)}


def test_gather_and_sum_in_pieces_on_a_one_rank_group(tmp_path):
    """`launch.mesh.gather` sends a tensor of more than 2**20 elements in
    concurrent pieces; each lands in place, and `sum_over` of one rank is
    the tensor."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        g = torch.Generator().manual_seed(7)
        for shape in [(), (0,), (3, 5), (3, (1 << 20) + 7)]:
            t = torch.randn(shape, generator=g)
            got = mesh.gather(t, None)
            assert got.shape == (1, *shape) and torch.equal(got[0], t)
            assert torch.equal(mesh.sum_over(t, None), t)
        assert mesh.staged_transfers()["to_host"] == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("op", OP_SET)
def test_grad_off_mesh_equals_the_local_wrapper(op):
    a = {k: t.requires_grad_() for k, t in _operands(2).items()
         if k != "sA"}
    a["sA"] = -torch.rand(4, generator=torch.Generator().manual_seed(3))
    before = ssd_kernel.einsum_dispatches
    got = _grad_calls(a, CPU, local=False)[op]()
    # under grad `ssd` takes the einsum form, counted as on `cuda`
    assert ssd_kernel.einsum_dispatches - before == (op == "ssd")
    want = _grad_calls(a, CPU, local=True)[op]()
    assert torch.equal(got, want)
    leaves = [t for t in a.values() if t.requires_grad]
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(5))
    g_got = torch.autograd.grad(got, leaves, dy, allow_unused=True)
    g_want = torch.autograd.grad(want, leaves, dy, allow_unused=True)
    used = [(g, w) for g, w in zip(g_got, g_want) if w is not None]
    assert used and all(g is not None and torch.equal(g, w) for g, w in used)
    with torch.no_grad():
        before = ssd_kernel.einsum_dispatches
        assert torch.equal(_grad_calls(a, CPU, local=False)[op](), want)
        assert ssd_kernel.einsum_dispatches == before


def test_decode_shaped_attention_under_grad_is_refused_by_name():
    a = {k: t.requires_grad_() for k, t in _operands(2).items()
         if k in ("dq", "dk", "dv")}
    with pytest.raises(NotImplementedError,
                       match=r"op 'attention' on backend 'sharded_cuda' is "
                             r"differentiable, but this dispatch"):
        CPU.attention(a["dq"], a["dk"], a["dv"])
    with torch.no_grad():
        assert np.isfinite(np.asarray(
            CPU.attention(a["dq"], a["dk"], a["dv"]))).all()
