"""The comparison that decides ``correct``: every served output of the
window against the plain reference of its image.

The served output is the softmax over the classes.  Its log is the
logits less their log-sum-exp, so the gap between the program's and the
reference's log-probabilities is a gap of logits, whatever the softmax
does to their scale.  The number compared is its largest magnitude over
every class of every compared request: ``max_log_prob_gap``.  A request
that was due and never answered is ``missing``; its limit is 0.
"""
from __future__ import annotations

import numpy as np

TINY = float(np.finfo(np.float32).tiny)


def log_gap(served: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per row, max |log served - log reference| (float64)."""
    a = np.log(np.maximum(served.astype(np.float64), TINY))
    b = np.log(np.maximum(reference.astype(np.float64), TINY))
    return np.abs(a - b).max(axis=1)


def compare(served: np.ndarray, pool_index: np.ndarray,
            reference: dict[int, np.ndarray], rows: int = 4096
            ) -> np.ndarray:
    """The gap of each served row against the reference output of its
    pool image, in blocks of `rows`."""
    gaps = np.empty(len(served))
    for i in range(0, len(served), rows):
        idx = pool_index[i:i + rows]
        ref = np.stack([reference[int(k)] for k in idx])
        gaps[i:i + rows] = log_gap(served[i:i + rows], ref)
    return gaps


def checks(gap: float, missing: int, limit: float) -> list[dict]:
    """The numbers compared, each beside its limit."""
    return [{"name": "max_log_prob_gap", "value": gap, "limit": limit},
            {"name": "missing_requests", "value": missing, "limit": 0}]


def passed(items: list[dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in items)
