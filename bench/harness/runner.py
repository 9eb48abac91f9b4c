"""One run of one cell: set-up, the measured window, the check, the
metrics, the result line.

Set-up makes the weights and the image pool from the seed, builds the
program's `Network` with those weights and its `CompileCache` over the
cell's buckets, warms every bucket, checks the plan, and runs a short
stretch of the cell's own traffic.  The window then drives
`CNNServingEngine.step` for the cell's seconds:

- a closed loop (``"loop": "closed"``) keeps ``backlog`` requests
  waiting, so every dispatch is a full top bucket;
- an open loop (``"loop": "open"``) submits each request when it is due
  and steps while any waits; requests due in the window are all served,
  after the window if need be, and their latency runs from the due time.

The program sees only the requests; the spans around its calls, the
counters read from its `CompileCache` and the energy counter are the
benchmark's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import math
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness import arith, check, devtrace, nvml, spec, traffic, weights
from harness.devtrace import DeviceTrace
from reference import cfg as ref_cfg
from reference import darknet as ref_net
from repro_torch.core.darknet.network import Network
from repro_torch.core.engine import make_engine
from repro_torch.serve.frontend import CNNServingEngine, ImageRequest

DRAIN_S = 60.0  # how long after the window an open loop waits for answers


@dataclasses.dataclass
class BenchRequest(ImageRequest):
    pool_index: int = -1
    t_due: float = math.nan
    t_step: float = math.nan  # start of the step that drained it


@dataclasses.dataclass
class Run:
    """What the metric readers read (`bench/metrics/*.py`)."""
    cell: spec.Cell
    table: list
    setup_s: float
    t0: float                  # the window, host clock
    t1: float
    requests: list             # the window's requests (BenchRequest)
    completed: int             # of them, answered inside [t0, t1]
    energy_j: float | None
    rows_real: int             # CompileCache rows over the window
    rows_padded: int
    dispatches: dict           # bucket -> dispatches in the window
    device: DeviceTrace | None
    peak: dict | None          # arith.PEAKS entry of this card


def _say(out, text: str) -> None:
    print(text, file=out, flush=True)


def _step(engine: CNNServingEngine) -> list:
    drained = list(itertools.islice(engine.pending, engine.max_batch))
    t = time.perf_counter()
    with record_function("bench.step"):
        engine.step()
    for r in drained:
        r.t_step = t
    return drained


def _step_summary(reqs: list) -> str:
    """Steps of the window by their host time: count, batch and the
    10th, 50th and 90th percentiles in ms (from the requests' stamps)."""
    steps = {}
    for r in reqs:
        if r.done:
            steps[r.t_step] = (r.t_done - r.t_step, steps.get(
                r.t_step, (0, 0))[1] + 1)
    if not steps:
        return "steps: none"
    ms = sorted(d * 1e3 for d, _ in steps.values())
    q = [ms[min(len(ms) - 1, int(p * len(ms)))] for p in (0.1, 0.5, 0.9)]
    batch = sum(n for _, n in steps.values()) / len(steps)
    return (f"steps: {len(ms)}, mean batch {batch:.2f}, ms p10 {q[0]:.3f} "
            f"p50 {q[1]:.3f} p90 {q[2]:.3f}")


class _Source:
    """Requests in the seed's order over the pool."""

    def __init__(self, images: np.ndarray, order: np.ndarray):
        self.images = images
        self.order = order
        self.made: list[BenchRequest] = []

    def make(self, t_due: float) -> BenchRequest:
        n = len(self.made)
        k = int(self.order[n % len(self.order)])
        req = BenchRequest(n, image=self.images[k], pool_index=k,
                           t_due=t_due)
        self.made.append(req)
        return req


def _closed(engine, source, backlog: int, *, steps: int | None = None,
            until: float | None = None) -> None:
    """Keep `backlog` waiting and step: `steps` times, or while the clock
    is before `until`."""
    n = 0
    while (steps is not None and n < steps) or (
            until is not None and time.perf_counter() < until):
        while len(engine.pending) < backlog:
            engine.submit(source.make(time.perf_counter()))
        _step(engine)
        n += 1


def open_loop(engine, reqs: list, deadline: float, i: int = 0) -> int:
    """Submit each request from index `i` on at its due time and step
    while any waits, until every request is answered or the clock passes
    `deadline`.  Returns the index of the first request not submitted."""
    while True:
        now = time.perf_counter()
        if now > deadline:
            return i
        while i < len(reqs) and reqs[i].t_due <= now:
            engine.submit(reqs[i])
            i += 1
        if engine.pending:
            _step(engine)
        elif i < len(reqs):
            with record_function("bench.wait"):
                time.sleep(max(0.0, reqs[i].t_due - time.perf_counter()))
        else:
            return i


def schedule(source, seed: int, rate: float, seconds: float,
              start: float) -> list:
    return [source.make(start + float(t))
            for t in traffic.arrival_offsets(seed, rate, seconds)]


def _plan_check(cache, backend: str, buckets, out) -> int:
    """Every bucket of the cell is built and every op of its plan runs on
    `backend`; returns the build count the window must keep."""
    stats = cache.stats()
    if tuple(stats["compiled"]) != tuple(sorted(buckets)):
        raise RuntimeError(f"buckets built {stats['compiled']}, the cell "
                           f"serves {sorted(buckets)}")
    ops: dict = {}
    for b in cache.buckets:
        for (be, op), n in cache.get(b).op_counts.items():
            if be != backend:
                raise RuntimeError(f"bucket {b} runs {op} on backend {be}, "
                                   f"not {backend}")
            ops[f"{be}.{op}"] = ops.get(f"{be}.{op}", 0) + n
    _say(out, f"plan check: buckets {list(stats['compiled'])} built, ops "
              f"{ops} on {backend}, builds {cache.trace_count}")
    return cache.trace_count


def _reference(table, params, images: np.ndarray, used: set, device,
               block: int) -> dict[int, np.ndarray]:
    """The plain reference's output for each pool image in `used`."""
    idx = sorted(used)
    outs = []
    with ref_net.precision(tf32=False), torch.no_grad():
        for i in range(0, len(idx), block):
            x = torch.from_numpy(images[idx[i:i + block]]).to(device)
            outs.append(ref_net.forward(table, params, x).cpu().numpy())
    return dict(zip(idx, np.concatenate(outs)))


@dataclasses.dataclass
class Prepared:
    """A cell's set-up: its inputs and the program built and warmed."""
    table: list
    raw: dict             # the raw parameters both sides take
    images: np.ndarray    # the pool
    source: _Source
    net: Network
    cache: object         # the program's CompileCache
    engine: CNNServingEngine
    builds: int           # the cache's builds after warm-up


def prepare(cell: spec.Cell, seed: int, device: torch.device,
            backend: str, out) -> Prepared:
    """Make the weights and the pool from the seed, build the program's
    `Network` with those weights and its `CompileCache` over the cell's
    buckets, warm every bucket and check the plan."""
    conf, prm = cell.config, cell.params
    table = ref_cfg.layers(conf["cfg_text"])
    raw = weights.make(table, conf["weights"], seed, device)
    images = traffic.pool(seed, prm["pool"], tuple(table[0].in_shape),
                          device)
    source = _Source(images, traffic.order(seed, prm["pool"]))
    net = Network(conf["cfg_text"], make_engine(backend, device=device))
    with torch.no_grad():
        for name, p in net.named_parameters():
            layer, key = name.split(".")
            p.copy_(raw[layer][key])
    cache = net.compile_cache(buckets=prm["buckets"]).warmup()
    builds = _plan_check(cache, backend, prm["buckets"], out)
    return Prepared(table, raw, images, source, net, cache,
                    CNNServingEngine(cache), builds)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: torch.device, backend: str = "cuda",
        out=None) -> dict:
    """Run the cell once and return the result line's object."""
    conf = cell.config
    prm = cell.params
    on_card = device.type == "cuda"
    card = nvml.Nvml(device.index or 0) if on_card else None
    if card is not None:
        _say(out, f"card: {torch.cuda.get_device_name(device)}, power "
                  f"limit {card.power_limit_w()} W")

    prep = prepare(cell, seed, device, backend, out)
    table, raw, images = prep.table, prep.raw, prep.images
    source, net, cache, engine = prep.source, prep.net, prep.cache, prep.engine
    builds = prep.builds

    closed = prm["loop"] == "closed"
    backlog = prm.get("backlog", 0)
    sampler = None
    if prm.get("energy") and card is not None and card.energy_mj() is not None:
        sampler = nvml.EnergySampler(card).start()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   ) if trace else contextlib.nullcontext()
    with prof:
        # the cell's own traffic before the window: clocks, allocator
        if closed:
            _closed(engine, source, backlog, steps=prm["warmup_steps"])
            first = len(source.made) - len(engine.pending)
            while len(engine.pending) < backlog:
                engine.submit(source.make(time.perf_counter()))
        else:
            open_loop(engine, schedule(source, seed, prm["rate_per_s"],
                                       prm["warmup_s"], time.perf_counter()),
                      time.perf_counter() + DRAIN_S)
        if sampler is not None:
            sampler.wait_ticks(2)
        before = cache.stats()
        setup_s = time.perf_counter() - t_start

        # ---- the measured window, with the garbage collector held off:
        # the requests the harness keeps for the check would otherwise
        # be walked by its full passes inside the window
        gc.collect()
        gc.disable()
        with record_function(devtrace.WINDOW):
            t0 = time.perf_counter()
            if closed:
                _closed(engine, source, backlog, until=t0 + seconds)
                # every request taken from the queue, the backlog that
                # was waiting at the window's start included
                waiting = {id(r) for r in engine.pending}
                reqs = [r for r in source.made[first:]
                        if id(r) not in waiting]
            else:
                reqs = schedule(source, seed, prm["rate_per_s"], seconds,
                                t0)
                submitted = open_loop(engine, reqs, t0 + seconds)
            t1 = time.perf_counter()
        gc.enable()
    window_builds = cache.trace_count
    after = cache.stats()
    if not closed:  # serve what was due in the window, then stop
        open_loop(engine, reqs, t1 + DRAIN_S, submitted)
    energy = None
    if sampler is not None:
        sampler.stop_after(t1)
        energy = sampler.joules(t0, t1)
    if window_builds != builds:
        raise RuntimeError(f"the program built {window_builds - builds} "
                           f"network(s) inside the window")
    _say(out, f"plan check: no build inside the window (builds "
              f"{window_builds})")
    _say(out, _step_summary(reqs))
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    dev = devtrace.read(prof) if trace else None

    # ---- free the program, then the check against the reference
    answered = [r for r in reqs if r.done]
    served = np.stack([r.result for r in answered]) if answered else None
    pool_index = np.array([r.pool_index for r in answered])
    del engine, cache, net, prep
    if on_card:
        torch.cuda.empty_cache()
    missing = len(reqs) - len(answered)
    gap = None
    if answered:
        ref = _reference(table, raw, images, set(pool_index.tolist()),
                         device, conf["reference_block"])
        gap = float(check.compare(served, pool_index, ref).max())
    items = check.checks(gap, missing, conf["limits"]["max_log_prob_gap"])

    completed = sum(1 for r in reqs if r.done and r.t_done <= t1)
    delta = {b: after["dispatches"].get(b, 0) - before["dispatches"].get(b, 0)
             for b in after["dispatches"]}
    runrec = Run(cell=cell, table=table, setup_s=setup_s,
                 t0=t0, t1=t1, requests=reqs, completed=completed,
                 energy_j=energy,
                 rows_real=after["rows_real"] - before["rows_real"],
                 rows_padded=after["rows_padded"] - before["rows_padded"],
                 dispatches={b: n for b, n in delta.items() if n},
                 device=dev,
                 peak=arith.PEAKS.get(torch.cuda.get_device_name(device))
                 if on_card else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m.name, cell.root)(runrec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {
        "correct": check.passed(items), "attempted": len(reqs),
        "failed": missing, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device)
                   if on_card else device.type,
                   "count": 1, "memory_peak_bytes": memory_peak}}
    if dev is not None:
        result["device"].update(busy_s=dev.busy_s, window_s=dev.window_s)
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in dev.by_name.most_common(10)],
            "idle_gaps": [[k, v] for k, v in
                          dev.idle_by_host.most_common(10)]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in items}
    if card is not None:
        card.close()
    return result
