"""Where a cell's traced window goes, by the program's own spans.

    python3 bench/tools/trace_spans.py --workload darknet19.batch \
        --seed 7 --seconds 20

Runs the cell once as ``bench/run.py ... --trace 1`` does and prints its
result line, then one JSON line of what `harness.spans` read from the
same profile: the device's idle seconds by the innermost span at each
gap's middle (the ten largest, and all of them with the Darknet layers
folded by type), the share of the idle seconds inside steps that no
span covers, the share of the window's device seconds linked to a span
through its launch, the device seconds by span, and how long the
reading took.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]


def _rounded(counter, n=None) -> list:
    return [[k, round(v, 6)] for k, v in counter.most_common(n)]


def by_layer_type(counter: collections.Counter) -> collections.Counter:
    """Seconds by label with each ``darknet.l{i}.{type}`` folded into
    ``darknet.{type}``."""
    out: collections.Counter = collections.Counter()
    for label, s in counter.items():
        parts = label.split(".")
        if (len(parts) == 3 and parts[0] == "darknet"
                and parts[1][1:].isdigit()):
            label = f"darknet.{parts[2]}"
        out[label] += s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch
    from harness import runner, spans, spec
    from repro_torch.kernels import build
    build.BUILD_DIR = ROOT / "build"
    if not torch.cuda.is_available():
        raise SystemExit("trace_spans: no CUDA device")
    cell = spec.load_cell(args.workload)
    result = runner.run(cell, args.seed, args.seconds, True,
                        t_start=T_START, device=torch.device("cuda", 0),
                        out=sys.stderr)
    print(json.dumps(result), flush=True)
    trace, read_s = spans.last()
    if trace is None:
        print(json.dumps({"spans": None}))
        return 0
    by_span = collections.Counter()
    for (span, _), s in trace.device.items():
        by_span[span] += s
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "idle_s": round(sum(trace.idle_by_span.values()), 6),
        "idle_by_span": _rounded(trace.idle_by_span, 10),
        "idle_by_span_type": _rounded(by_layer_type(
            trace.idle_by_span)),
        "no_span_share_of_step_idle": spans.no_span_share(trace),
        "device_s": trace.device_s(),
        "attributed_share": trace.attributed_share(),
        "unattributed_s": trace.unattributed_s,
        "device_by_span_type": _rounded(by_layer_type(by_span)),
        "stage_idle_s": trace.stage_idle_s,
        "cache_runs": len(trace.enqueue_s),
        "read_s": read_s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
