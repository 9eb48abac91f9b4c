"""Whole runs on the CPU: the harness with its look for a card skipped,
the program on its `eager` backend at 32 x 32.  A sound run is correct;
a run with the timed path broken underneath is not; a run with no card
prints no result."""
from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, shrink
from harness import runner, spec
from repro_torch.core.darknet.network import CompileCache
from repro_torch.serve.frontend import CNNServingEngine

CPU = torch.device("cpu")
SEED = 2**31 + 99


def _run(cell, seconds=0.4):
    return runner.run(cell, SEED, seconds, False, t_start=time.perf_counter(),
                      device=CPU, backend="eager", out=io.StringIO())


@pytest.mark.parametrize("name", ["darknet19.batch", "darknet19.stream",
                                  "darknet53.batch", "darknet53.stream"])
def test_sound_run_is_correct(name):
    res = _run(shrink(spec.load_cell(name)))
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]
    want = {m.name for m in spec.load_cell(name).end_to_end} - {
        "images_per_j"}  # no energy counter on the CPU
    assert set(res["metrics"]) == want
    json.dumps(res)


def _altered(real):
    def run(self, x):
        y = real(self, x).clone()
        y[0, 0] *= 1.01  # one answer altered where it is produced
        return y
    return run


def _half_left_out(real):
    def run(self, x):
        y = real(self, x).clone()
        n = y.shape[0]
        if n > 1:  # the second half of the batch takes the first's answers
            y[n - n // 2:] = y[:n // 2].mean(0)
        return y
    return run


def _dropped(real):
    def step(self):
        if len(self.pending) > 1:
            self.pending.pop()  # a request taken and never answered
        return real(self)
    return step


@pytest.mark.parametrize("name", ["darknet19.batch", "darknet53.stream"])
@pytest.mark.parametrize("fault", ["altered", "half_left_out", "dropped"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    if fault == "dropped":
        monkeypatch.setattr(CNNServingEngine, "step",
                            _dropped(CNNServingEngine.step))
    else:
        wrap = {"altered": _altered, "half_left_out": _half_left_out}[fault]
        monkeypatch.setattr(CompileCache, "run", wrap(CompileCache.run))
    res = _run(shrink(spec.load_cell(name)))
    assert res["correct"] is False


def test_a_new_cell_is_files_only(tmp_path):
    """A configuration, traffic mix, cell, metric and kernel class added
    as new files, found by name with no edit to a file that is there."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (root / "configs" / "tiny.cfg").write_text(
        "[net]\nheight=16\nwidth=16\nchannels=3\n\n[convolutional]\n"
        "batch_normalize=1\nfilters=8\nsize=3\nstride=1\npad=1\n"
        "activation=leaky\n\n[maxpool]\nsize=2\nstride=2\n\n[avgpool]\n\n"
        "[connected]\noutput=10\nactivation=linear\n\n[softmax]\n")
    conf = json.loads((root / "configs" / "darknet19.json").read_text())
    conf.update(name="tiny", cfg="tiny.cfg")
    (root / "configs" / "tiny.json").write_text(json.dumps(conf))
    (root / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "closed", "pool": 8, "warmup_steps": 1}))
    (root / "workloads" / "tiny.burst.json").write_text(json.dumps(
        {"buckets": [4], "backlog": 8}))
    (root / "metrics" / "dispatches.burst.py").write_text(
        "def read(run):\n    return sum(run.dispatches.values())\n")
    (root / "kernel_classes" / "other.json").write_text(json.dumps(
        {"layers": ["convolutional"], "names": ["other_kernel"]}))
    man["workloads"].append({"name": "tiny.burst", "config": "tiny",
                             "traffic": "burst", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "dispatches.burst", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "build cache", "moves": "images_per_s",
                             "workloads": ["tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = spec.load_cell("tiny.burst", root=root)
    assert [m.name for m in cell.per_layer] == ["dispatches.burst"]
    assert "other" in spec.kernel_classes(root)
    res = runner.run(cell, SEED, 0.3, True, t_start=time.perf_counter(),
                     device=CPU, backend="eager", out=io.StringIO())
    assert res["correct"] is True
    assert res["metrics"]["dispatches.burst"]["value"] > 0


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "darknet19.batch", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=BENCH.parent)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
