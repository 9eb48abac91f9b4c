"""Find the highest arrival rate a stream cell sustains, on the card.

    python3 bench/tools/sweep_rate.py --workload darknet19.stream \
        --seed 11 --seconds 8 --rates 100 200 300 400

Sets the cell up once, then for each rate runs the cell's open loop for
`--seconds` and serves every request due, printing one JSON line a rate:
the p95 latency from due time to answer, the requests, the largest
backlog and the drain (from the last request's due time to its answer).
A rate is sustained when the p95 is under the traffic's
``latency_limit_ms`` and the drain is under one step's worth of it, so
the backlog did not grow.  The cell's rate is then set by hand in its
file at 60 % of the highest rate sustained.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch
    from harness import runner, spec
    from harness.stats import percentile
    from repro_torch.kernels import build
    build.BUILD_DIR = ROOT / "build"
    if not torch.cuda.is_available():
        raise SystemExit("sweep_rate: no CUDA device")
    cell = spec.load_cell(args.workload)
    prm = cell.params
    prep = runner.prepare(cell, args.seed, torch.device("cuda", 0), "cuda",
                          sys.stderr)
    limit = prm["latency_limit_ms"]
    for rate in args.rates:
        runner.open_loop(prep.engine, runner.schedule(
            prep.source, args.seed, rate, prm["warmup_s"],
            time.perf_counter()), time.perf_counter() + runner.DRAIN_S)
        reqs = runner.schedule(prep.source, args.seed, rate, args.seconds,
                               time.perf_counter())
        runner.open_loop(prep.engine, reqs,
                         time.perf_counter() + args.seconds + runner.DRAIN_S)
        lat = [r.t_done - r.t_due for r in reqs]
        p95 = percentile(lat, 95)
        drain_ms = (reqs[-1].t_done - reqs[-1].t_due) * 1e3
        served = sum(r.done for r in reqs)
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "requests": len(reqs), "served": served,
            "p50_ms": percentile(lat, 50) * 1e3 if served else None,
            "p95_ms": p95 * 1e3 if p95 is not None else None,
            "drain_ms": drain_ms,
            "sustained": bool(p95 is not None and p95 * 1e3 <= limit
                              and drain_ms <= limit)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
