"""Fault-tolerance machinery: failure injection, straggler watchdog,
elastic restart planning (a copy of ``repro/launch/fault.py``, which imports
no jax; the port keeps its own).

In a trainer loop on a fleet these hooks sit as follows:
  * FailureInjector: a deterministic crash at step N (REPRO_FAIL_AT_STEP)
    so the restart path is exercised in tests, not discovered in
    production;
  * StepWatchdog: an EWMA step-time tracker; a step slower than
    ``threshold x`` the EWMA marks a straggler event.  Policy: log, trigger
    checkpoint-now (bounding lost work), and after ``evict_after``
    consecutive events recommend shrinking the mesh (elastic plan below);
  * plan_elastic_mesh: given the surviving chip count, the largest
    (data, model) mesh that keeps tensor parallelism intact: node failures
    shrink the data axis only, so checkpoints restore with the same
    tensor-parallel layout and only the batch re-slices.
"""
from __future__ import annotations

import os
import time


class FailureInjected(RuntimeError):
    pass


class FailureInjector:
    """Crash deterministically at a chosen step (env or ctor arg)."""

    def __init__(self, fail_at_step: int | None = None):
        env = os.environ.get("REPRO_FAIL_AT_STEP")
        self.fail_at = fail_at_step if fail_at_step is not None else (
            int(env) if env else None)

    def check(self, step: int):
        if self.fail_at is not None and step == self.fail_at:
            raise FailureInjected(f"injected failure at step {step}")


class StepWatchdog:
    """EWMA straggler detector."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2,
                 evict_after: int = 3):
        self.threshold, self.alpha, self.evict_after = (threshold, alpha,
                                                        evict_after)
        self.ewma: float | None = None
        self.consecutive = 0
        self.events: list[tuple[int, float, float]] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> dict:
        dt = time.monotonic() - self._t0
        is_straggler = (self.ewma is not None
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.consecutive += 1
            self.events.append((step, dt, self.ewma))
        else:
            self.consecutive = 0
            self.ewma = (dt if self.ewma is None
                         else self.alpha * dt + (1 - self.alpha) * self.ewma)
        return {
            "step_time_s": dt,
            "ewma_s": self.ewma if self.ewma is not None else dt,
            "straggler": is_straggler,
            "checkpoint_now": is_straggler,
            "recommend_evict": self.consecutive >= self.evict_after,
        }


def plan_elastic_mesh(surviving_chips: int, tp: int = 16) -> tuple[int, int]:
    """Largest (data, model=tp) mesh fitting the surviving chips.

    TP stays intact (a TP group dies with its node, so survivors are counted
    in whole TP groups); DATA shrinks to the largest power-of-two that fits,
    keeping global batch divisible after re-slicing.
    """
    groups = surviving_chips // tp
    if groups < 1:
        raise ValueError("fewer surviving chips than one TP group")
    data = 1
    while data * 2 <= groups:
        data *= 2
    return data, tp
