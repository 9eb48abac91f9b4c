"""`kernels.sharded.route` / `predict`, the sharded backend's path
decision as a pure function, held to what the sharded ops count, on two
gloo ranks of the CPU.

One spawn of two ranks (`launch.mesh.spawn`, a file store in tmp_path)
runs `repro_torch.launch.mesh_checks.collective_check` on reduced
qwen2-0.5b: serve runs of the slot and paged engines on ("data",) (the
row and batch paths), on ("model",) (KV-head groups) and a slot engine
whose batch of one against 512-row caches takes the sequence split, and
train runs (one loss and gradient, steps with replicated moments and
with ZeRO-1 moments under "tp" and "fsdp") and DARKNET_SMALL_CFG's loss,
gradients and one train step on ("data",).  After each run the paths
and the collectives `predict` reads off the run's dispatch log (with
`optimizer.zero1_collectives` for the ZeRO-1 steps) equal
`sharded.path_counts()` and `sharded.collective_counts()` (with
`launch.mesh.staged_transfers()`, which stay 0 on host tensors), on
both ranks.  Each rank's ZeRO-1 moments hold the bytes the dry run
predicts for the cell (`lower_cell(..., mesh={"data": 2})`).  One process
also holds `route`'s bytes to hand counts.
"""
import pytest
import torch

from repro_torch.configs import base
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.kernels import sharded
from repro_torch.launch import dryrun, mesh, mesh_checks

torch.set_num_threads(1)

DATA = ((2,), ("data",))
MODEL = ((2,), ("model",))
PAGED = dict(kv_blocks=8, block_size=8, max_len=32, chunk=4)
REQUESTS = [((3, 7, 11, 2, 9), 4), ((5, 1), 5), ((8, 8, 8, 4, 2, 6, 1), 3),
            ((13,), 4)]
SERVE = [dict(name="slot_batch", engine="slot", mesh=DATA,
              kwargs=dict(slots=2, max_len=32), requests=REQUESTS),
         dict(name="slot_heads", engine="slot", mesh=MODEL,
              kwargs=dict(slots=2, max_len=32), requests=REQUESTS),
         dict(name="slot_seq", engine="slot", mesh=DATA,
              kwargs=dict(slots=1, max_len=512), requests=REQUESTS[:2]),
         dict(name="paged_batch", engine="paged", mesh=DATA, kwargs=PAGED,
              requests=REQUESTS)]
LM = dict(arch="qwen2-0.5b", reduced=True, seed=3, batch=(4, 32),
          data_seed=5, ce_chunk=16, runs=[
              dict(name="grad_data", mesh=DATA),
              dict(name="grad_model", mesh=MODEL),
              dict(name="steps_data", mesh=DATA, steps=2),
              dict(name="zero1_data", mesh=DATA, steps=2, zero1=True),
              dict(name="zero1_fsdp", mesh=DATA, strategy="fsdp", steps=2,
                   zero1=True)])


CNN = dict(cfg=DARKNET_SMALL_CFG, name="DARKNET_SMALL_CFG", seed=6, batch=4,
           data_seed=7, runs=[dict(name="cnn_data", mesh=DATA)])


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    spec = dict(arch="qwen2-0.5b", reduced=True, seed=3, serve=SERVE,
                lm=[LM], cnn=[CNN],
                ocfg=dict(lr=1e-3, warmup_steps=1, decay_steps=2))
    store = tmp_path_factory.mktemp("predict") / "store"
    return mesh.spawn(mesh_checks.collective_check, 2, "cpu", spec,
                      device_type="cpu", store_path=store, timeout=300)


@pytest.mark.parametrize("name", [r["name"] for r in SERVE])
def test_serve_counts_are_predicted(checked, name):
    for rank in checked:
        run = next(r for r in rank["serve"] if r["name"] == name)
        assert run["done"]
        assert run["predicted"]["paths"] == run["paths"]
        assert run["predicted"]["collectives"] == run["collectives"]
        assert run["collectives"]["all_gather"] > 0
    want = {"slot_batch": "attention_batch", "slot_heads": "attention_heads",
            "slot_seq": "attention_seq", "paged_batch": "attention_batch"}
    assert want[name] in checked[0]["serve"][
        [r["name"] for r in SERVE].index(name)]["paths"]


@pytest.mark.parametrize("name", [r["name"] for r in LM["runs"]])
def test_train_counts_are_predicted(checked, name):
    for rank in checked:
        run = next(r for r in rank["lm"][0]["runs"] if r["name"] == name)
        assert run["predicted"]["paths"] == run["paths"]
        assert run["predicted"]["collectives"] == run["collectives"]
        # dW summed over the ranks on the row path; q, k, v's cotangents
        # gathered on the heads path
        assert run["collectives"]["sum" if run["paths"].get(
            "matmul_rows") else "all_gather"] > 0
        assert all(run["collectives"][k] == 0 for k in (
            "to_host", "to_device", "to_host_bytes", "to_device_bytes"))


def test_cnn_counts_are_predicted(checked):
    """The im2col conv's patch rows and the connected layers on the row
    path, the folded batch-norm scale and shift summed under grad."""
    for rank in checked:
        run = rank["cnn"][0]["runs"][0]
        assert run["predicted"]["paths"] == run["paths"]
        assert run["predicted"]["collectives"] == run["collectives"]
        assert run["paths"]["matmul_rows"] > 0
        assert run["collectives"]["sum"] > 0


@pytest.mark.parametrize("name,strategy", [("zero1_data", "tp"),
                                           ("zero1_fsdp", "fsdp")])
def test_zero1_moment_bytes_are_the_dry_run_s(checked, name, strategy):
    """Each rank's ZeRO-1 moments (`optimizer.zero1_init`) hold the bytes
    `lower_cell` gives the cell on the same mesh."""
    cfg = base.reduced(base.get_arch("qwen2-0.5b"))
    b, s = LM["batch"]
    want = dryrun.lower_cell(cfg, base.ShapeConfig("cell", s, b, "train"),
                             mesh={"data": 2}, strategy=strategy)
    whole = dryrun.lower_cell(cfg, base.ShapeConfig("cell", s, b, "train"),
                              mesh={})["memory"]["moments"]
    for rank in checked:
        run = next(r for r in rank["lm"][0]["runs"] if r["name"] == name)
        assert run["moment_bytes"] == want["memory"]["moments"]
    # under "tp" no leaf of the reduced config reaches 2**20 elements
    assert (want["memory"]["moments"] == whole) == (strategy == "tp")


def test_route_bytes_by_hand():
    sizes = {"data": 2, "model": 4}
    r = sharded.route("matmul", (8, 16, 32), sizes, "tp",
                      grad=(True, True, False, True))
    assert r.path == "matmul_rows" and r.axes == ("data",)
    assert r.forward == (sharded.Collective("all_gather", "data", 2,
                                            4 * 32 * 4, 8 * 32 * 4),)
    assert [c.kind for c in r.backward] == ["all_gather", "sum", "sum"]
    assert r.backward[1].in_bytes == 16 * 32 * 4
    assert r.backward[2].out_bytes == 2 * 32 * 4
    # batch 2 and 2 KV heads over 'model' of 4: only the batch divides
    a = sharded.route("attention", ((2, 5, 8, 16), (2, 9, 2, 16)), sizes,
                      "tp", itemsize=2, grad=(True, False, False))
    assert a.path == "attention_batch" and a.heads is None
    assert a.forward[0].in_bytes == 1 * 5 * 8 * 16 * 2
    assert len(a.backward) == 1
    # under "fsdp" the model dim carries batch, the last dim gathered first
    f = sharded.route("attention", ((8, 5, 8, 16), (8, 9, 2, 16)), sizes,
                      "fsdp")
    assert f.path == "attention_batch" and f.axes == ("data", "model")
    assert [(c.dim, c.in_bytes) for c in f.forward] == [
        ("model", 5 * 8 * 16 * 4), ("data", 4 * 5 * 8 * 16 * 4)]
    s = sharded.route("attention", ((1, 1, 8, 16), (1, 512, 2, 16)), sizes)
    assert s.path == "attention_seq" and s.axes == ("data", "model")
    assert s.backward == () and s.forward[0].in_bytes == 8 * 17 * 4
    assert sharded.route("ssd", ((1, 4, 2, 8), (1, 4, 1, 8), 4),
                         sizes).path is None
    assert sharded.route("matmul", (8, 16, 32), {}).path == "matmul_local"
    assert sharded.route("bmm", (3, 4, 5, 6), {"data": 2}).path == \
        "bmm_local"
