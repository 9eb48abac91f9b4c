"""95th percentile, nearest rank, over every request due in the window,
from its due time to its answer (``t_done``); one never answered ranks
above all."""
from harness.stats import percentile


def read(run):
    p = percentile([r.t_done - r.t_due for r in run.requests], 95)
    return None if p is None else p * 1e3
