"""Serving frontend (PyTorch port of ``repro/serve/frontend.py``).

The paper's framework is an inference accelerator: build the network once,
then feed it a stream of requests.  This module is the traffic side of that
deployment shape: a `ServingFrontend` protocol, a shared `Request` base
carrying identity + lifecycle + latency timestamps, and one stats schema
(`STATS_KEYS`) that the LM engines (serve/engine.py, serve/scheduler.py)
share.

`CNNServingEngine` drains its request queue into padded-bucket dispatches
through a `CompileCache`: each step stacks up to top-bucket images, pads to
the smallest bucket that fits, runs ONE compiled call, waits for the
device, and completes every request in the batch.  Per-request latency and
aggregate images/sec come out of `stats()`.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import random
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.darknet.network import CompileCache
from repro_torch.core.engine import synchronize

# Every ServingFrontend.stats() dict carries at least these keys; "requests"
# is itself a dict with the REQUEST_KEYS counters and "latency_s" a dict
# with the LATENCY_KEYS aggregates.  Engine-specific extras ride alongside.
STATS_KEYS = ("engine", "requests", "steps", "wall_s", "latency_s",
              "throughput")
REQUEST_KEYS = ("submitted", "completed", "rejected", "truncated")
LATENCY_KEYS = ("avg", "max", "p50", "p95", "p99")


class RejectedRequest(ValueError):
    """An ADMISSION failure: the request itself is inadmissible (bad image
    shape, a prompt the KV cache cannot hold) and was counted as
    rejected.

    Engines raise this, and only this, from `submit`'s admission checks,
    so `run` can skip a rejected request and keep serving the batch while
    any other ValueError (a programming error) propagates."""


@dataclasses.dataclass
class Request:
    """Base serving request: identity, lifecycle, latency timestamps.

    Engines set `t_submit` at admission and `t_done` at completion;
    `latency_s` is the queueing + execution time in between, NaN until the
    request completes.  Lifecycle fields are keyword-only so subclass
    payload fields keep their positional slots right after `rid`.
    """
    rid: int
    done: bool = dataclasses.field(default=False, kw_only=True)
    truncated: bool = dataclasses.field(default=False, kw_only=True)
    t_submit: float = dataclasses.field(default=float("nan"), kw_only=True)
    t_done: float = dataclasses.field(default=float("nan"), kw_only=True)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class ImageRequest(Request):
    """One image through a compiled CNN; `result` holds the network output
    (a numpy array on the host)."""
    image: np.ndarray | None = None
    result: np.ndarray | None = None


class ServingFrontend(abc.ABC):
    """The serving protocol: `submit(req)`, `step() -> work`, `run(reqs)`,
    `stats() -> dict` (STATS_KEYS schema).

    `step()` returns the number of requests it advanced (0 = idle), so
    `run` is engine-agnostic: submit everything, step until idle.
    `submit` raises `RejectedRequest` on an inadmissible request; `run`
    catches exactly that per request (the request stays `done=False`),
    while any other exception propagates.
    """

    @abc.abstractmethod
    def submit(self, req: Request) -> None:
        ...

    @abc.abstractmethod
    def step(self) -> int:
        ...

    @abc.abstractmethod
    def stats(self) -> dict:
        ...

    def run(self, requests: list, max_steps: int = 10_000) -> list:
        for r in requests:
            try:
                self.submit(r)
            except RejectedRequest:
                pass  # rejected: counted in stats, left not-done
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return requests


class LatencyAgg:
    """Running per-request latency aggregate: O(1) sum/max/count plus a
    bounded reservoir for tail percentiles.

    Percentiles (p50/p95/p99, nearest-rank) come from reservoir sampling
    (Algorithm R) with a seeded RNG: up to `reservoir` samples are exact,
    beyond that each sample survives with probability k/n, and the result
    is stable across runs for a fixed sample stream.

    Only COMPLETED requests may be aggregated: `add` refuses a non-finite
    sample (a rejected or in-flight request's NaN latency would poison
    avg/max for the server's lifetime)."""

    def __init__(self, reservoir: int = 4096):
        if reservoir < 1:
            raise ValueError(f"need reservoir >= 1, got {reservoir}")
        self.sum = 0.0
        self.max = 0.0
        self.count = 0
        self._capacity = reservoir
        self._samples: list[float] = []
        self._rng = random.Random(0)

    def add(self, latency_s: float) -> None:
        if not math.isfinite(latency_s):
            raise ValueError(
                f"non-finite latency sample {latency_s!r}: only COMPLETED "
                "requests (t_submit and t_done set) may be aggregated")
        self.sum += latency_s
        self.max = max(self.max, latency_s)
        self.count += 1
        if len(self._samples) < self._capacity:
            self._samples.append(latency_s)
        else:  # Algorithm R: keep with probability capacity/count
            j = self._rng.randrange(self.count)
            if j < self._capacity:
                self._samples[j] = latency_s

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the reservoir; 0.0 when empty."""
        if not self._samples:
            return 0.0
        ordered = sorted(self._samples)
        rank = math.ceil(p / 100.0 * len(ordered))
        return ordered[max(0, rank - 1)]

    def summary(self) -> dict:
        return {"avg": (self.sum / self.count) if self.count else 0.0,
                "max": self.max,
                "p50": self.percentile(50),
                "p95": self.percentile(95),
                "p99": self.percentile(99)}


def build_stats(*, engine: str, submitted: int, completed: int,
                rejected: int, truncated: int, steps: int, wall_s: float,
                latency: LatencyAgg, items: int,
                extra: dict | None = None) -> dict:
    """Assemble the shared stats dict; `items` is the engine's throughput
    unit (images for CNN, generated tokens for LM)."""
    stats = {
        "engine": engine,
        "requests": {"submitted": submitted, "completed": completed,
                     "rejected": rejected, "truncated": truncated},
        "steps": steps,
        "wall_s": wall_s,
        "latency_s": latency.summary(),
        "throughput": (items / wall_s) if wall_s > 0 else 0.0,
    }
    if extra:
        stats.update(extra)
    return stats


class CNNServingEngine(ServingFrontend):
    """Micro-batching CNN server over a bucketed `CompileCache`.

    submit() queues `ImageRequest`s (shape-checked against the network's
    input plan); each step() drains up to top-bucket requests, stacks them
    into one ragged batch on the network's device, dispatches through
    `CompileCache.run` (pad/slice and one build per bucket live there),
    and synchronises the device before it stamps `t_done`.
    """

    def __init__(self, cache: CompileCache):
        self.cache = cache
        self.max_batch = cache.buckets[-1]
        self.in_shape = tuple(cache.net.in_shape)  # (H, W, C)
        self.device = cache.net.engine.device
        self.pending: deque[ImageRequest] = deque()
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._steps = 0
        self._wall_s = 0.0
        self._latency = LatencyAgg()

    def submit(self, req: ImageRequest) -> None:
        try:
            img = np.asarray(req.image)
        except (ValueError, TypeError) as e:
            self._rejected += 1  # count before raising: run() skips it
            raise RejectedRequest(f"bad image payload: {e}") from e
        if tuple(img.shape) != self.in_shape:
            self._rejected += 1
            raise RejectedRequest(
                f"image shape {tuple(img.shape)} != network "
                f"input {self.in_shape}")
        req.image = img
        req.t_submit = time.perf_counter()
        self.pending.append(req)
        self._submitted += 1

    def step(self) -> int:
        """Drain one micro-batch through the compile cache."""
        if not self.pending:
            return 0
        t0 = time.perf_counter()
        batch = [self.pending.popleft()
                 for _ in range(min(self.max_batch, len(self.pending)))]
        x = torch.as_tensor(np.stack([r.image for r in batch]))
        y = self.cache.run(x.to(self.device, self.cache.dtype))
        synchronize(self.device)
        t1 = time.perf_counter()
        y = y.cpu().numpy()
        for i, r in enumerate(batch):
            r.result = y[i]
            r.done = True
            r.t_done = t1
            self._latency.add(r.latency_s)
        self._completed += len(batch)
        self._steps += 1
        self._wall_s += t1 - t0
        return len(batch)

    def stats(self) -> dict:
        return build_stats(
            engine="cnn", submitted=self._submitted,
            completed=self._completed, rejected=self._rejected, truncated=0,
            steps=self._steps, wall_s=self._wall_s,
            latency=self._latency, items=self._completed,
            extra={"images": self._completed, "cache": self.cache.stats()})
