"""What the profiler saw on the card inside the measured window.

The harness brackets the window with ``record_function("bench.window")``
and each host phase with ``bench.step`` or ``bench.wait``.  From the
profiler's raw events this keeps the device's kernels and copies clipped
to the window, and labels each idle stretch of the device by what the
host was doing at its middle: the harness phase, and inside a step the
outermost PyTorch operator running then (none: NumPy or Python).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"
PHASES = ("bench.step", "bench.wait")


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    by_name: collections.Counter   # device seconds by kernel or copy name
    copies: collections.Counter    # device seconds by copy name
    idle_by_host: collections.Counter  # idle seconds by host activity

    def seconds_matching(self, needles) -> float:
        """Device seconds of the kernels whose name contains a needle."""
        return sum(s for name, s in self.by_name.items()
                   if name not in self.copies
                   and any(n in name for n in needles))

    def kernel_s(self) -> float:
        return sum(s for name, s in self.by_name.items()
                   if name not in self.copies)


def short(name: str) -> str:
    """A kernel's name without anonymous namespaces and its argument list
    (the first parenthesis outside template brackets), at most 120
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]


def _is_cuda(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _activity(ev) -> str:
    fn = getattr(ev, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _union(intervals) -> tuple[float, list[tuple[int, int]]]:
    """Total covered nanoseconds and the merged intervals."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def _outermost(spans):
    """Spans (start, end, name) not inside an earlier one, by start."""
    out = []
    for s, e, name in sorted(spans):
        if not out or s >= out[-1][1]:
            out.append((s, e, name))
    return out


def _at(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return None


def read(prof) -> DeviceTrace | None:
    """The window's device trace from a finished ``torch.profiler``
    profile, or None when the profiler recorded no device event."""
    events = prof.profiler.kineto_results.events()
    window = [ev for ev in events
              if ev.name() == WINDOW and not _is_cuda(ev)]
    if not window:
        return None
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    dev, host_phase, host_ops = [], [], []
    by_name: collections.Counter = collections.Counter()
    copies: collections.Counter = collections.Counter()
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if _is_cuda(ev):
            if "annotation" in _activity(ev) or name.startswith("bench."):
                continue  # the device's mirror of a host range
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            dev.append((s, e))
            key = short(name)
            by_name[key] += (e - s) / 1e9
            if name.startswith(("Memcpy", "Memset")):
                copies[key] += (e - s) / 1e9
        elif name in PHASES:
            host_phase.append((s, e, name))
        elif name.startswith("aten::"):
            host_ops.append((s, e, name))
    if not dev:
        return None
    busy_ns, merged = _union(dev)
    phases = _outermost(host_phase)
    ops = _outermost(host_ops)
    p_starts = [p[0] for p in phases]
    o_starts = [o[0] for o in ops]
    idle: collections.Counter = collections.Counter()
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        phase = _at(phases, p_starts, mid) or "harness"
        label = phase.removeprefix("bench.")
        if phase == "bench.step":
            label += ": " + (_at(ops, o_starts, mid) or "no torch op")
        idle[label] += (e - s) / 1e9
    return DeviceTrace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                       by_name=by_name, copies=copies, idle_by_host=idle)
