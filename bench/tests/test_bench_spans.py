"""`harness.spans` on synthetic profiler events, and the three readers of
the program's spans: an idle gap is labelled by the innermost span at its
middle, a kernel goes to the span of its launch through the correlation
id, a kernel whose launch lies in no program range is unattributed, and
every reader gives None without spans.  On the card (marked ``cuda``;
skipped on the CPU) a short traced run of a cell reads each of them
through `runner.run`."""
from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
from torch.profiler import profile

from conftest import BENCH
from harness import spans, spec


class Ev:
    """What `spans` reads of a raw profiler event."""

    def __init__(self, name, start, end, *, cuda=False, corr=0,
                 activity=""):
        self._name, self._start, self._dur = name, start, end - start
        self._cuda, self._corr, self._activity = cuda, corr, activity

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def activity_type(self):
        return self._activity

    def correlation_id(self):
        return self._corr


def _kernel(name, start, end, corr):
    return Ev(name, start, end, cuda=True, corr=corr, activity="kernel")


HOST = [("bench.window", 0, 1000), ("bench.step", 100, 900),
        ("serve.step", 100, 900), ("serve.stage", 110, 300),
        ("serve.h2d", 300, 340), ("serve.forward", 340, 800),
        ("cache.run", 345, 795), ("darknet.l0.convolutional", 350, 600),
        ("darknet.fold", 350, 360), ("repro.op.conv2d", 360, 590),
        ("darknet.l1.maxpool", 600, 700), ("serve.sync", 800, 850),
        ("cudaMemcpyAsync", 310, 312), ("cudaLaunchKernel", 370, 371),
        ("cuLaunchKernel", 380, 381), ("cudaLaunchKernel", 610, 611),
        ("cudaLaunchKernel", 50, 51)]
CORR = {310: 3, 370: 1, 380: 2, 610: 6, 50: 4}
DEVICE = [("Memcpy HtoD (Pageable -> Device)", 320, 340, 3),
          ("CatArrayBatchedCopy", 400, 450, 1),
          ("gemm_fwd_kernel", 450, 620, 2), ("max_pool_kernel", 650, 700, 6),
          ("stray", 950, 960, 4),      # launched outside every range
          ("orphan", 970, 980, 5)]     # its launch was not recorded


def _events():
    evs = [Ev(n, s, e, corr=CORR.get(s, 0)) for n, s, e in HOST]
    evs += [_kernel(*d) for d in DEVICE]
    # the device's mirror of a host range is no device work
    evs.append(Ev("serve.step", 100, 900, cuda=True,
                  activity="gpu_user_annotation"))
    return evs


def test_idle_gaps_are_labelled_by_the_innermost_span():
    trace = spans.from_events(_events())
    got = {k: round(v * 1e9) for k, v in trace.idle_by_span.items()}
    assert got == {"serve.stage": 320, "repro.op.conv2d": 60,
                   "darknet.l1.maxpool": 30, "serve.sync": 250,
                   "harness": 30}
    assert round(trace.stage_idle_s * 1e9) == 210   # [110, 320)
    assert trace.window_s == pytest.approx(1e-6)


def test_idle_inside_a_step_outside_every_span():
    evs = [Ev("bench.window", 0, 100), Ev("bench.step", 0, 100),
           Ev("serve.step", 10, 90), Ev("cudaLaunchKernel", 20, 21, corr=1),
           _kernel("k", 40, 95, 1)]
    trace = spans.from_events(evs)
    got = {k: round(v * 1e9) for k, v in trace.idle_by_span.items()}
    assert got == {"serve.step": 40, spans.NO_SPAN: 5}
    assert spans.no_span_share(trace) == pytest.approx(5 / 45)


def test_kernels_go_to_the_span_of_their_launch():
    trace = spans.from_events(_events())
    got = {k: round(v * 1e9) for k, v in trace.device.items()}
    assert got == {
        ("serve.h2d", "Memcpy HtoD "): 20,   # `devtrace.short`'s name
        ("repro.op.conv2d", "CatArrayBatchedCopy"): 50,
        ("repro.op.conv2d", "gemm_fwd_kernel"): 170,
        ("darknet.l1.maxpool", "max_pool_kernel"): 50}
    assert trace.copies == {"Memcpy HtoD "}
    assert trace.enqueue_s == [pytest.approx(450e-9)]


@pytest.mark.parametrize("kernel", ["stray", "orphan"])
def test_a_kernel_launched_in_no_range_is_unattributed(kernel):
    evs = [ev for ev in _events() if not ev._cuda or ev.name() in (
        kernel, "gemm_fwd_kernel")]
    trace = spans.from_events(evs)
    assert round(trace.unattributed_s * 1e9) == 10
    assert trace.attributed_share() == pytest.approx(170 / 180)


def test_no_program_range_no_spans():
    evs = [ev for ev in _events()
           if not ev.name().startswith(spans.PREFIXES)]
    assert spans.from_events(evs) is None


def test_the_profile_is_found_beside_the_run():
    run = types.SimpleNamespace()
    prof = profile()
    assert spans._profile_of(run) is prof

    def elsewhere():  # a run no caller holds
        return spans._profile_of(types.SimpleNamespace())
    found = elsewhere()
    assert found is None


METRICS = ["stage_idle_share.batch", "enqueue_ms_p50.stream",
           "im2col_ms_per_image.batch"]


def _run(device):
    return types.SimpleNamespace(device=device, completed=2,
                                 cell=types.SimpleNamespace(root=BENCH))


@pytest.mark.parametrize("metric", METRICS)
def test_readers_give_none_without_spans(metric, monkeypatch):
    assert spec.reader(metric)(_run(None)) is None
    monkeypatch.setattr(spans, "_profile_of", lambda run: None)
    assert spec.reader(metric)(_run(object())) is None


@pytest.mark.parametrize("metric, value", [
    ("stage_idle_share.batch", 21.0),
    ("enqueue_ms_p50.stream", 450e-6),
    ("im2col_ms_per_image.batch", 50e-6 / 2)])
def test_readers_read_the_spans(metric, value, monkeypatch):
    trace = spans.from_events(_events())
    monkeypatch.setattr(spans, "of", lambda run: trace)
    assert spec.reader(metric)(_run(object())) == pytest.approx(value)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["darknet19.batch", "darknet53.stream"])
def test_traced_run_on_the_card_reads_the_spans(name, card):
    """`spans.of` finds the profile beside the run inside `runner.run`:
    each span metric of the cell is in the traced result line."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", str(2**31 + 4243), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    want = {m.name for m in spec.load_cell(name).per_layer
            if m.name in METRICS}
    assert want and want <= set(got)
    if name.endswith(".batch"):
        assert got["stage_idle_share.batch"] <= got[
            "device_idle_share.batch"]
        assert got["im2col_ms_per_image.batch"] <= got[
            "glue_ms_per_image.batch"]
    else:
        assert got["enqueue_ms_p50.stream"] > 0
