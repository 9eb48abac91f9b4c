"""Deterministic synthetic data pipeline with host-side prefetch (a copy of
``repro/data/pipeline.py``, which imports no jax; the port keeps its own).

Deterministic: batch t of a run seeded with `seed` is a pure function of
(seed, step, shard), which is what makes checkpoint/restart bit-for-bit
reproducible (launch/train.py) and lets elastic restarts re-slice the same
global stream across a different data-parallel size without skew.

The token stream is a splitmix64-style integer hash, cheap, stateless and
uniform over the vocab, so data order never depends on wall clock, host
count or filesystem layout.  A file-backed memmap corpus can be dropped in
via ``corpus=`` without changing the trainer.  Batches are numpy arrays;
the trainer moves them to the device.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class SyntheticLM:
    """Global-batch token/label generator for any (arch, shape) cell."""

    def __init__(self, cfg, shape, seed: int = 0, corpus: np.ndarray | None
                 = None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.corpus = corpus

    def batch(self, step: int) -> dict:
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        n_vis = cfg.frontend_tokens if cfg.frontend == "vision" else 0
        out = {}
        if cfg.frontend == "audio":
            idx = (np.uint64(self.seed) * np.uint64(1 << 32)
                   + np.uint64(step) * np.uint64(B * S)
                   + np.arange(B * S, dtype=np.uint64))
            h = _splitmix64(idx).astype(np.float64)
            frames = ((h / 2**64) * 2 - 1).astype(np.float32)
            out["frames"] = np.repeat(frames.reshape(B, S, 1),
                                      cfg.frontend_dim, axis=2)
        else:
            n_text = S - n_vis
            idx = (np.uint64(self.seed) * np.uint64(1 << 32)
                   + np.uint64(step) * np.uint64(B * S)
                   + np.arange(B * n_text, dtype=np.uint64))
            toks = (_splitmix64(idx) % np.uint64(cfg.vocab_size)).astype(
                np.int32).reshape(B, n_text)
            if self.corpus is not None:
                pos = (_splitmix64(idx) % np.uint64(
                    max(len(self.corpus) - 1, 1))).astype(np.int64)
                toks = self.corpus[pos].reshape(B, n_text).astype(np.int32)
            out["tokens"] = toks
            if n_vis:
                vidx = (np.uint64(self.seed + 1) * np.uint64(1 << 32)
                        + np.uint64(step) + np.arange(
                            B * n_vis * cfg.frontend_dim, dtype=np.uint64))
                v = (_splitmix64(vidx).astype(np.float64) / 2**64 * 2 - 1)
                out["patch_embeds"] = v.astype(np.float32).reshape(
                    B, n_vis, cfg.frontend_dim)
        lidx = (np.uint64(self.seed + 2) * np.uint64(1 << 32)
                + np.uint64(step) * np.uint64(B * S)
                + np.arange(B * S, dtype=np.uint64))
        if "tokens" in out and n_vis == 0 and self.corpus is None:
            labels = np.roll(out["tokens"], -1, axis=1)
        else:
            labels = (_splitmix64(lidx) % np.uint64(cfg.vocab_size)).astype(
                np.int32).reshape(B, S)
        out["labels"] = labels
        return out


class Prefetcher:
    """Double-buffered host prefetch thread feeding the device step."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int
                 = 2):
        self._src = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._src.batch(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
