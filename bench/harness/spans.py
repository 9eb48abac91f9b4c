"""The program's own spans in the traced window, linked to the device.

The program opens a profiler range at each layer boundary of its CNN
serving path (`repro_torch.scopes.span`): ``serve.*`` for a step's
phases, ``cache.*`` for a dispatch's host enqueue, ``darknet.*`` for each
layer and the BN fold, ``repro.op.*`` for each engine dispatch.  From the
same raw profiler events as `devtrace.read`, this

- links each device kernel or copy of the window to the innermost
  program range that holds its launch: the runtime call (``cudaLaunch*``,
  ``cuLaunch*``, ``cudaMemcpy*``, ...) with the device event's
  correlation id; a kernel whose launch is missing or lies in no program
  range is unattributed;
- labels each idle stretch of the device by the innermost program range
  at its middle; inside ``bench.step`` outside every range "no span",
  outside a step the harness phase as `devtrace` names it ("wait",
  "harness");
- keeps the host seconds of each outermost ``cache.run`` that starts in
  the window, and the idle seconds spent inside a step's staging.

The run record carries no profiler: the harness keeps it as a local of
the function that calls each reader, and `of(run)` finds it there, so
the readers of `bench/metrics/` need no field of their own.  A program
that opens no such range gives None.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import sys
import time
import weakref

from harness.devtrace import (PHASES, WINDOW, _activity, _at, _is_cuda,
                              _outermost, _union, short)

PREFIXES = ("serve.", "cache.", "darknet.", "repro.op.")
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
            "cudaGraphLaunch")
STAGING = ("serve.stage", "serve.h2d")
NO_SPAN = "no span"
_short = functools.lru_cache(maxsize=None)(short)


@dataclasses.dataclass
class SpanTrace:
    window_s: float
    device: collections.Counter    # device s by (innermost span, kernel)
    copies: set                    # kernel names that are copies or fills
    unattributed_s: float          # device s with no program range found
    idle_by_span: collections.Counter  # idle s by label (module doc)
    stage_idle_s: float            # idle s inside ``serve.stage``/``.h2d``
    enqueue_s: list                # host s of each outermost ``cache.run``

    def device_s(self) -> float:
        return sum(self.device.values()) + self.unattributed_s

    def attributed_share(self) -> float:
        total = self.device_s()
        return sum(self.device.values()) / total if total else 0.0


def _innermost(ranges, times) -> list:
    """For each time of the sorted `times`, the name of the innermost of
    the nested `ranges` (start, end, name) that holds it, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, open_, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while open_ and open_[-1][1] <= ranges[i][0]:
                open_.pop()
            open_.append(ranges[i])
            i += 1
        while open_ and open_[-1][1] <= t:
            open_.pop()
        out.append(open_[-1][2] if open_ else None)
    return out


def _overlap_ns(a, b) -> int:
    """Nanoseconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def from_events(events) -> SpanTrace | None:
    """The spans of the window from raw profiler events (what
    ``prof.profiler.kineto_results.events()`` gives), or None without a
    window, a device event or a program range."""
    window, dev, ranges, phases, launch_at = None, [], [], [], {}
    for ev in events:
        name = ev.name()
        if name.startswith("aten::"):
            continue   # most of the events; none is read here
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_cuda(ev):
            # a device event named as a host range mirrors that range
            if not ("annotation" in _activity(ev) or name.startswith(
                    "bench.") or name.startswith(PREFIXES)):
                dev.append((s, e, name, ev.correlation_id()))
        elif name.startswith(PREFIXES):
            ranges.append((s, e, name))
        elif name in PHASES:
            phases.append((s, e, name))
        elif name == WINDOW:
            window = window or (s, e)
        elif name.startswith(LAUNCHES):
            launch_at[ev.correlation_id()] = s
    if window is None:
        return None
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), _short(name), corr,
            name.startswith(("Memcpy", "Memset")))
           for s, e, name, corr in dev if min(e, w1) > max(s, w0)]
    if not dev or not ranges:
        return None

    device: collections.Counter = collections.Counter()
    copies, unattributed = set(), 0.0
    linked = []
    for s, e, key, corr, copy in dev:
        if copy:
            copies.add(key)
        t = launch_at.get(corr)
        if t is None:
            unattributed += (e - s) / 1e9
        else:
            linked.append((t, key, (e - s) / 1e9))
    linked.sort()
    for (_, key, sec), span in zip(linked, _innermost(
            ranges, [t for t, _, _ in linked])):
        if span is None:
            unattributed += sec
        else:
            device[span, key] += sec

    _, merged = _union([(s, e) for s, e, *_ in dev])
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    steps = _outermost(phases)
    starts = [p[0] for p in steps]
    idle: collections.Counter = collections.Counter()
    for (s, e), span in zip(gaps, _innermost(
            ranges, [(s + e) // 2 for s, e in gaps])):
        phase = _at(steps, starts, (s + e) // 2) or "harness"
        if phase != "bench.step":
            span = phase.removeprefix("bench.")
        idle[span or NO_SPAN] += (e - s) / 1e9

    staging = _union([(s, e) for s, e, name in ranges if name in STAGING])[1]
    enqueue = [(e - s) / 1e9 for s, e, name in _outermost(
        [r for r in ranges if r[2] == "cache.run"]) if w0 <= s < w1]
    return SpanTrace(window_s=(w1 - w0) / 1e9, device=device, copies=copies,
                     unattributed_s=unattributed, idle_by_span=idle,
                     stage_idle_s=_overlap_ns(gaps, staging) / 1e9,
                     enqueue_s=enqueue)


# a weak reference to the last profile read, its spans, the seconds taken
_last: list = [None, None, 0.0]


def read(prof) -> SpanTrace | None:
    """The spans of a finished ``torch.profiler`` profile; read once a
    profile and kept for the next reader."""
    ref, trace, _ = _last
    if ref is not None and ref() is prof:
        return trace
    t0 = time.perf_counter()
    trace = from_events(prof.profiler.kineto_results.events())
    _last[:] = [weakref.ref(prof), trace, time.perf_counter() - t0]
    return trace


def last() -> tuple[SpanTrace | None, float]:
    """The spans of the last profile read, and the seconds reading took."""
    return _last[1], _last[2]


def _profile_of(run):
    """The profile held beside `run` by a function that called us."""
    from torch.profiler import profile
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if any(v is run for v in local.values()):
            for v in local.values():
                if isinstance(v, profile):
                    return v
        frame = frame.f_back
    return None


def of(run) -> SpanTrace | None:
    """The spans of `run`'s traced window; None in an untraced run, on
    the CPU and for a program that opens no span."""
    if run.device is None:
        return None
    prof = _profile_of(run)
    return None if prof is None else read(prof)


def no_span_share(trace: SpanTrace) -> float:
    """Of the idle seconds inside steps, the share outside every span."""
    inside = sum(s for label, s in trace.idle_by_span.items()
                 if label not in ("harness", "wait"))
    return trace.idle_by_span[NO_SPAN] / inside if inside else 0.0

