"""Measured autotuning: candidate timing and a per-device persisted table
(PyTorch port of ``repro/core/autotune.py``).

fpgaConvNet and CNN2Gate close the gap to hand-tuned FPGA implementations
by *measuring* design points in the tiling space instead of trusting a
static heuristic.  This module supplies the two halves that the registry
cache (core/backends.py) composes into a measured autotuner:

  * a timing protocol, `time_thunk()`: on a CUDA device a warm call, then
    enough calls captured in one CUDA graph for a replay to last about
    `REPLAY_MS` (at most `MAX_CAPTURED`), the graph replayed between CUDA
    events and the median per call taken, so a kernel of a few
    microseconds is not timed through the host's launch overhead; on the
    CPU the median wall clock of fenced calls;
  * a per-device persisted table: one JSON file per device fingerprint
    (the card's name, compute capability, the CUDA version torch was built
    with, the platform and the table version) under
    `~/.cache/repro_autotune/` (override with `REPRO_AUTOTUNE_CACHE`),
    loaded lazily and written atomically (tempfile + `os.replace`), so a
    second process on the same device serves every pick from disk and
    performs no measurement.

Policy selection (`off | heuristic | measure`) and the in-process cache
live in core/backends.py; this module knows nothing about backends or ops.
A corrupted or stale table file is never fatal: it reads as empty and the
caller measures, then overwrites it with a valid table.

The table's format and key strings are the JAX package's, so a table of
one package reads in the other; the fingerprints never match (a torch one
carries ``torch-cuda`` or ``torch-cpu``), so neither package ever serves or
merges the other's file in a shared cache directory:

    {
      "version": 1,
      "fingerprint": "NVIDIA-H100-80GB-HBM3__sm90__cuda12.8__torch-cuda__v1",
      "entries": {
        "[\"matmul\",[512,256,128],\"float32\",\"cuda\"]": {
          "pick": ["B", 64, 32],
          "est_ms": 0.041,
          "candidates_timed": [[["B", 64, 32], 0.041], ...],
          "source": "measured"
        }
      }
    }
"""
from __future__ import annotations

import json
import math
import os
import statistics
import tempfile
import time
from typing import Any, Callable

import torch

TABLE_VERSION = 1

# Timing protocol defaults (env-overridable for slow CI machines).
DEFAULT_WARMUP = int(os.environ.get("REPRO_AUTOTUNE_WARMUP", "1"))
DEFAULT_REPS = int(os.environ.get("REPRO_AUTOTUNE_REPS", "3"))
# A CUDA-graph replay holds enough calls to last about this long ...
REPLAY_MS = 0.5
# ... and no more than this many.
MAX_CAPTURED = 20

# Lazily loaded tables, keyed by file path: path -> {key_str: record}.
_TABLES: dict[str, dict[str, dict]] = {}


# ------------------------------------------------------------ identity ---

def key_str(op: str, shapes: tuple, dtype_str: str, backend: str) -> str:
    """Canonical JSON string for a cache key (tuples become arrays), used
    both as the persisted-table dict key and in `autotune_report()`; the
    JAX package's string for the same arguments.  `dtype_str` is JAX's
    name of the dtype (``"float32"``, ``"bfloat16"``)."""
    return json.dumps([op, shapes, dtype_str, backend],
                      separators=(",", ":"))


def device_fingerprint() -> str:
    """Identity of the device this process measures on.

    On a card: its name, compute capability and the CUDA version torch was
    built with, then ``torch-cuda``; without one ``cpu__torch-cpu``; then
    the table version, which invalidates tables when the schema or the
    candidate space changes.
    """
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        raw = (f"{torch.cuda.get_device_name()}__sm{major}{minor}"
               f"__cuda{torch.version.cuda}__torch-cuda__v{TABLE_VERSION}")
    else:
        raw = f"cpu__torch-cpu__v{TABLE_VERSION}"
    return "".join(c if c.isalnum() or c in "._-" else "-" for c in raw)


def cache_dir() -> str:
    """Persistence directory: `REPRO_AUTOTUNE_CACHE` or the XDG-ish
    default `~/.cache/repro_autotune` (read per call, so tests and
    deployments can redirect it without re-importing)."""
    return os.path.expanduser(
        os.environ.get("REPRO_AUTOTUNE_CACHE", "~/.cache/repro_autotune"))


def table_path(fingerprint: str | None = None) -> str:
    return os.path.join(cache_dir(),
                        f"{fingerprint or device_fingerprint()}.json")


# --------------------------------------------------------- persistence ---

def _read_table(path: str) -> dict[str, dict]:
    """Parse a table file; corrupted, stale-version or wrong-device files
    read as empty (the caller then measures and rewrites them)."""
    try:
        with open(path) as f:
            raw = json.load(f)
        if (raw.get("version") != TABLE_VERSION
                or raw.get("fingerprint") != os.path.splitext(
                    os.path.basename(path))[0]):
            return {}
        entries = raw.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}
    except (OSError, json.JSONDecodeError, ValueError, AttributeError):
        return {}


def _table(path: str) -> dict[str, dict]:
    tab = _TABLES.get(path)
    if tab is None:
        tab = _TABLES[path] = _read_table(path)
    return tab


def lookup(key: str) -> dict | None:
    """Persisted record for a key on this device, or None."""
    rec = _table(table_path()).get(key)
    return dict(rec) if rec is not None else None


def store(key: str, record: dict) -> bool:
    """Insert a record in memory and persist the table atomically.

    Re-reads the file before writing so concurrent processes tuning
    disjoint shapes merge instead of clobbering each other; `os.replace`
    keeps readers from ever seeing a torn file.  Persistence is never
    fatal: on an unwritable cache dir the measured pick still serves this
    process and False is returned; only the cross-process reuse is lost.
    """
    path = table_path()
    merged = _read_table(path)
    merged.update(_table(path))
    merged[key] = dict(record)
    _TABLES[path] = merged
    payload = {"version": TABLE_VERSION,
               "fingerprint": os.path.splitext(os.path.basename(path))[0],
               "entries": merged}
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".autotune-", suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return True
    except OSError:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


def reset() -> None:
    """Drop the lazily-loaded in-memory tables (tests use this to simulate
    a fresh process: the next lookup re-reads from disk)."""
    _TABLES.clear()


# -------------------------------------------------------------- timing ---

def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False without
    a card).  Nothing may be measured then: a measurement captures a graph
    of its own, and captures do not nest."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _graph_ms(thunk: Callable[[], Any], warmup: int, reps: int) -> float:
    """`time_thunk` on the card: the protocol of ``chip_smoke.py``'s
    `graph_ms`, with the number of captured calls sized from one call
    timed by CUDA events."""
    for _ in range(max(warmup, 1)):
        thunk()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    thunk()
    end.record()
    end.synchronize()
    calls = max(1, min(MAX_CAPTURED,
                       math.ceil(REPLAY_MS / max(start.elapsed_time(end),
                                                 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            thunk()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(max(reps, 1)):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(samples)


def time_thunk(thunk: Callable[[], Any], *, warmup: int = DEFAULT_WARMUP,
               reps: int = DEFAULT_REPS) -> float:
    """Median milliseconds of one call of `thunk`.

    With a card (the bench thunks launch on the current CUDA device): a
    warm call, then as many calls as last about `REPLAY_MS` (1 to
    `MAX_CAPTURED`) captured in one CUDA graph, replayed `reps` times
    between CUDA events; the median of the per-call times.  Without one:
    `warmup` untimed calls, then the median wall clock of `reps` calls.
    """
    if torch.cuda.is_available():
        return _graph_ms(thunk, warmup, reps)
    for _ in range(max(warmup, 0)):
        thunk()
    samples = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        thunk()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e3
