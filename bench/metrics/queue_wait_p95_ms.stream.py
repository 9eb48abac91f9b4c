"""95th percentile of the wait from a request's due time to the start of
the `CNNServingEngine.step` that drained it (the benchmark's spans)."""
from harness.stats import percentile


def read(run):
    p = percentile([r.t_step - r.t_due for r in run.requests], 95)
    return None if p is None else p * 1e3
