"""`repro_torch.analysis.diagnose`, the per-op bottleneck attribution the
lint report reuses for its totals, held to the cases of
tests/test_diagnose.py: a real trace, records outside every scope
(labelled by their op, as JAX falls back to the HLO op name), repeated
ops (the count standing where JAX carries a while loop's trip count), the
degenerate inputs a broken run could hand it, and the printed report;
then the collectives a dispatch log makes on a mesh
(`count_collectives`, `full_kv_gathers`) against `kernels.sharded.predict`,
and the CLI on one dry-run cell's meta trace.
"""
import pytest
import torch

from repro_torch import scopes
from repro_torch.analysis import diagnose, trace_cost
from repro_torch.analysis import trace as trace_lib
from repro_torch.core import make_engine
from repro_torch.kernels import sharded

torch.set_num_threads(1)


def _trace():
    def f(x, w):
        return torch.tanh(x @ w)
    trace, _ = trace_lib.trace_call(f, torch.zeros(8, 16),
                                    torch.zeros(16, 32))
    return trace


def test_attribute_on_a_real_trace():
    rep = diagnose.attribute(_trace(), top=5)
    assert rep["totals"]["flops"] >= 2 * 8 * 16 * 32
    assert rep["traffic"], "no traffic rows from a real program"
    assert len(rep["traffic"]) <= 5
    for size, op, count, label in rep["traffic"]:
        assert size >= 0 and count >= 1 and isinstance(op, str)
    assert rep["collectives"] == []       # no mesh


def test_attribute_without_scopes_labels_by_op():
    """Records outside every scope fall back to their op as the label;
    a registry dispatch is one row at its boundary, under its scope."""
    rep = diagnose.attribute(_trace(), top=5)
    assert all(label for _, _, _, label in rep["traffic"])
    assert {label for _, _, _, label in rep["traffic"]} == {"aten::mm",
                                                            "aten::tanh"}
    eng = make_engine("eager", device="cpu")
    trace, _ = trace_lib.trace_call(lambda x, w: eng.matmul(x, w, act="relu"),
                                    torch.zeros(8, 16), torch.zeros(16, 32))
    rows = diagnose.attribute(trace)["traffic"]
    assert [(op, n, label) for _, op, n, label in rows] == [
        ("matmul", 1, "repro.op.matmul")]
    assert rows[0][0] == 4 * (8 * 16 + 16 * 32 + 8 * 32)


def test_repeated_ops_carry_their_count():
    """Three adds of one scope are one row x3, as JAX's while body rows
    carry the trip multiplier: read 2 x 512 B, write 512 B, three times."""
    def f(x):
        with scopes.named_scope("body"):
            for _ in range(3):
                x = x + x
        return x
    trace, _ = trace_lib.trace_call(f, torch.zeros(128))
    rows = diagnose.attribute(trace, top=20)["traffic"]
    adds = [r for r in rows if r[1] == "aten::add"]
    assert adds == [(3.0 * (2 * 512 + 512), "aten::add", 3, "body")]


def test_degenerate_inputs_do_not_crash():
    for trace in (trace_lib.Trace(), _trace()):
        rep = diagnose.attribute(trace)
        assert set(rep) == {"collectives", "traffic", "totals"}
    # a boundary whose region recorded no aten call (a kernel launch)
    trace = trace_lib.Trace(boundaries={7: trace_lib.Record(
        0, "matmul", (trace_lib.TensorInfo((8,), "float32", 32),), (),
        "repro.op.matmul", 7, False, 0, "op")})
    rep = diagnose.attribute(trace)
    assert rep["traffic"] == [(32.0, "matmul", 1, "repro.op.matmul")]
    assert diagnose.count_collectives([], {"data": 2}) == {}
    assert trace_cost.analyze(trace_lib.Trace())["collectives"] == {
        "total": 0}


def test_print_report_smoke(capsys):
    diagnose.print_report(_trace(), top=5)
    out = capsys.readouterr().out
    assert "flops=" in out
    assert "top memory traffic" in out


LOG = ({"op": "matmul", "shapes": (64, 32, 16), "dtype": "float32",
        "tiles": ()},
       {"op": "attention", "shapes": ((4, 16, 4, 32), (4, 16, 2, 32)),
        "dtype": "float32", "tiles": ()},
       {"op": "attention", "shapes": ((2, 1, 4, 32), (2, 512, 2, 32)),
        "dtype": "float32", "tiles": ()})


def test_collectives_equal_sharded_predict():
    """On a two-rank data mesh: the matmul's rows and the prefill's batch
    each gather their output once, the decode-shaped dispatch splits its
    keys and gathers its (o, lse) partials; the counts and link bytes are
    `sharded.predict`'s."""
    sizes = {"data": 2}
    counts = diagnose.count_collectives(LOG, sizes)
    pred = sharded.predict(LOG, sizes)
    assert counts == {"all_gather": pred["collectives"]["all_gather"]} == {
        "all_gather": 3}
    rep = diagnose.attribute(trace_lib.Trace(), log=LOG, sizes=sizes)
    assert sum(r[0] for r in rep["collectives"]) == pred["link_bytes"] == \
        rep["totals"]["collectives"]["total"]
    assert sum(r[2] for r in rep["collectives"]) == 3


def test_full_kv_gathers():
    """No gather of the sharded paths holds a whole K or V: the decode's
    sequence split gathers Sq-sized partials only."""
    sizes = {"data": 2}
    kv_elems = 2 * 512 * 2 * 32
    assert diagnose.full_kv_gathers(LOG, sizes, kv_elems) == []
    # at a threshold of 1024 elements the matmul's (64, 16) and the
    # prefill's (4, 16, 4, 32) outputs count; the decode's partials, 264
    # elements, never do
    bad = diagnose.full_kv_gathers(LOG, sizes, 64 * 16)
    assert [b.split(":")[0] for b in bad] == ["dispatch 0 matmul",
                                              "dispatch 1 attention"]


def test_main_on_a_dry_run_cell(capsys):
    """The CLI traces one dry-run cell on the meta device."""
    diagnose.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                   "--top", "3"])
    out = capsys.readouterr().out
    assert "cell: mamba2-1.3b x decode_32k" in out
    assert "top memory traffic" in out and "t_comp=" in out


def test_unknown_cell_raises():
    with pytest.raises(ValueError):
        diagnose.main(["--arch", "no-such-arch", "--shape", "decode_32k"])
