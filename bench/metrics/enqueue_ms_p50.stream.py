"""Median host milliseconds of the program's ``cache.run`` spans (the
outermost ones that start in the traced window): one dispatch's bucket
choice, padding, the network's Python and launches, and the slice
(`harness.spans`)."""
import statistics

from harness import spans


def read(run):
    trace = spans.of(run)
    if trace is None or not trace.enqueue_s:
        return None
    return 1e3 * statistics.median(trace.enqueue_s)
