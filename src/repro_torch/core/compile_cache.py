"""Bucketed step cache: one build per shape bucket for an arbitrary step
function (PyTorch port of ``repro/core/compile_cache.py``).

LM serving dispatches steps whose batch size and block-table width vary
per step.  The scheduler pads every dynamic axis up to a bucket from a
fixed set (`pick_bucket`), so the number of distinct step shapes is bounded
by the bucket-set product, whatever the traffic.

PyTorch has no trace, so a "build" here is the first dispatch of a bucket
key: `StepCompileCache` keys each call on the shapes and dtypes of its
array arguments (tensors and numpy arrays passed directly; containers such
as the parameter dict are fixed for the cache's life and are not walked),
counts a build the first time it sees a key, and counts every call.  The
trace-bound gate of the JAX package keeps its meaning: `traces` <= the
bucket-set product.  `_build` is where a per-bucket CUDA graph capture
plugs in (a later PR): it returns the callable that serves a key, today the
step function itself.

`topology` is a hashable mesh fingerprint (`sharding.hints.mesh_topology`:
``(("data", 2),)``, or ``()`` off-mesh).  It extends every shape key, so
each topology owns its builds, and it prefixes the recorded dispatch keys,
so `stats()['dispatches']` tells the same bucket under two meshes apart.
Off-mesh the keys are as before.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable

import numpy as np
import torch


def normalize_buckets(buckets: Iterable[int]) -> tuple[int, ...]:
    """Sorted unique positive bucket sizes.  Raises ValueError when empty
    or non-positive."""
    bs = tuple(sorted({int(b) for b in buckets}))
    if not bs or bs[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return bs


def pick_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n.  Raises ValueError when n exceeds the top
    bucket (callers split oversize work before dispatch) or n < 1."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the top bucket of {buckets}")


def shape_key(args: tuple) -> tuple:
    """(shape, dtype) of every tensor or numpy argument, in order."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in args
                 if isinstance(a, (torch.Tensor, np.ndarray)))


class StepCompileCache:
    """One build per shape bucket for a step function.

    ``cache(*args)`` runs the callable built for the arguments' shape key
    (`shape_key`), building it on first sight.  `traces` counts builds,
    `calls` every call; `record(key)` logs one dispatch under a
    caller-chosen bucket key for `stats()['dispatches']`.
    """

    def __init__(self, fn: Callable, *, name: str = "step",
                 topology: tuple = ()):
        self.name = name
        self.topology = tuple(topology)
        self._fn = fn
        self._built: dict = {}
        self.calls = 0
        self._dispatch_shapes = collections.Counter()

    def _build(self, key: tuple) -> Callable:
        """The callable that serves shape key `key`: the step function
        (the hook for a per-bucket CUDA graph)."""
        return self._fn

    def __call__(self, *args):
        self.calls += 1
        key = self.topology + shape_key(args)
        fn = self._built.get(key)
        if fn is None:
            fn = self._built[key] = self._build(key)
        return fn(*args)

    def record(self, key) -> None:
        """Log one dispatch under a caller-chosen bucket key (prefixed by
        the mesh topology when one is set)."""
        self._dispatch_shapes[self.topology + tuple(key)] += 1

    @property
    def traces(self) -> int:
        return len(self._built)

    def stats(self) -> dict:
        return {"name": self.name, "traces": self.traces,
                "calls": self.calls, "topology": self.topology,
                "dispatches": dict(self._dispatch_shapes)}
