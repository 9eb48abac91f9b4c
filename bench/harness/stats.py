"""Small statistics the metric readers share."""
from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    """Nearest-rank percentile over every value, a missing one (NaN)
    ranking above all; None when there is no value or the rank lands on
    a missing one."""
    if not values:
        return None
    ordered = sorted(values, key=lambda v: math.inf if math.isnan(v) else v)
    v = ordered[max(0, math.ceil(p / 100 * len(ordered)) - 1)]
    return None if math.isnan(v) else v
