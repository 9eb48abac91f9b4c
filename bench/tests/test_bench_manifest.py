"""BENCHMARK.json against the contract's form, and every file it names."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH
from harness import spec

MAN = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("item", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda i: i["name"])
def test_names(item):
    assert NAME.match(item["name"])
    for key in ("config", "traffic"):
        if key in item:
            assert NAME.match(item[key])
    for key in item.get("reduced", []):
        assert NAME.match(key)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = ({"host_clock", "device_trace"} if metric in MAN["end_to_end"]
               else {"device_trace", "program_span", "program_counter",
                     "host_clock"})
    assert metric["source"] in allowed
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    moved = {m["name"]: m for m in MAN["end_to_end"]}[metric["moves"]]
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    c = spec.load_cell(cell)
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert c.chips == 1


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers == {"serving", "build cache", "model step", "kernels",
                      "glue", "device"}


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = BENCH.parent / conf["file"]
    body = json.loads(path.read_text())
    assert body["source"] == conf["source"]
    assert body["reduced"] == conf["reduced"] == []
    assert (path.parent / body["cfg"]).is_file()
    assert any(w["config"] == conf["name"] for w in MAN["workloads"])
