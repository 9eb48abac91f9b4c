"""Where the benchmark's data lives, and how a cell is put together from it.

Everything that belongs to one configuration, traffic mix, metric or
kernel class is a file of its own, found by its name:

    BENCHMARK.json                      the cells, metrics and bounds
    bench/configs/<config>.json         sizes, source, assumptions
    bench/configs/<config>.cfg          the Darknet description
    bench/traffic/<traffic>.json        a mix's shared parameters
    bench/workloads/<cell>.json         the cell's own parameters
    bench/metrics/<metric>.py           a reader: ``read(run) -> float|None``
    bench/kernel_classes/<class>.json   device kernel names of a layer kind
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # bench/configs/<config>.json, with "cfg_text"
    params: dict          # traffic file, then the cell's file over it
    chips: int
    end_to_end: list[Metric]
    per_layer: list[Metric]
    root: Path = BENCH    # where its files were found


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str, root: Path = BENCH) -> dict:
    """A configuration's JSON with its cfg text under ``cfg_text``."""
    conf = _json(root / "configs" / f"{name}.json")
    conf["cfg_text"] = (root / "configs" / conf["cfg"]).read_text()
    return conf


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Path | None = None,
              root: Path = BENCH) -> Cell:
    """The cell `name` of the manifest (``BENCHMARK.json`` at the
    repository root by default), with its files read.  Raises KeyError
    for a cell the manifest does not name."""
    man = _json(manifest or root.parent / "BENCHMARK.json")
    entry = {w["name"]: w for w in man["workloads"]}[name]
    params = _json(root / "traffic" / f"{entry['traffic']}.json")
    params.update(_json(root / "workloads" / f"{name}.json"))
    return Cell(
        name=name, config=load_config(entry["config"], root), params=params,
        chips=entry["chips"],
        end_to_end=[Metric(m["name"], m["unit"])
                    for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[Metric(m["name"], m["unit"])
                   for m in man["per_layer"] if _applies(m, name)],
        root=root)


def reader(metric: str, root: Path = BENCH) -> Callable:
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_classes(root: Path = BENCH) -> dict[str, dict]:
    """Every kernel class file: ``{class: {"layers": [...], "names":
    [...]}}``; a device kernel belongs to a class when its name contains
    one of the class's names."""
    return {p.stem: _json(p)
            for p in sorted((root / "kernel_classes").glob("*.json"))}
