"""Run one cell of the benchmark of ``repro_torch`` on one NVIDIA card.

    python3 bench/run.py --workload darknet19.batch --seed 7 --seconds 10 \
        --trace 0

From the root of a checkout.  Prints progress and the checks on standard
error, and as the last line of standard output one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), device, with ``--trace 1`` a
breakdown, and last the numbers compared with their limits.  Exits
non-zero with no result when there is no card, when the program cannot
be imported, or when JAX was loaded.

Every cache of the program is kept inside the checkout, at fixed paths
under ``build/``: the CUDA kernel libraries and the autotune table.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fail(code: int, why: str):
    print(f"bench: {why}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def _cache_dirs() -> None:
    build = ROOT / "build"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(build / "autotune")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        _fail(2, f"--seed is a whole number, got {args.seed}")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    _cache_dirs()

    from harness import spec
    try:
        cell = spec.load_cell(args.workload)
    except KeyError:
        _fail(2, f"BENCHMARK.json names no cell {args.workload!r}")

    import torch
    if not torch.cuda.is_available():
        _fail(3, "no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        _fail(3, f"the cell needs {cell.chips} card(s), "
                 f"{torch.cuda.device_count()} found")
    try:
        from repro_torch.kernels import build
        from harness import runner
    except ImportError as e:
        _fail(4, f"the program under test cannot be imported: {e}")
    build.BUILD_DIR = ROOT / "build"

    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START, device=torch.device("cuda", 0),
                        out=sys.stderr)
    found = forbidden_modules()
    if found:
        _fail(5, f"JAX or the JAX package was loaded: {found}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
