"""Seeds of the run's independent streams, all derived from ``--seed``."""
from __future__ import annotations

import numpy as np

STREAMS = ("weights", "images", "order", "arrivals")


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream`, a pure function of (seed, stream): any
    whole number seeds it, however large."""
    if seed < 0:
        raise ValueError(f"seeds are whole numbers, got {seed}")
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, seed >> 64,
             STREAMS.index(stream)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1]) & 0x7FFFFFFF) << 32


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))
