"""Where the time of one LM serving dispatch goes, on the card.

    PYTHONPATH=src python3 -m repro_torch.serve.profile_lm [--reps 10]

Builds full-width qwen2-0.5b (24 layers, seeded random weights) on the
`cuda` engine and a paged KV pool of 256 blocks of 16 rows, and runs
`--reps` calls of the paged step (`serve_step.make_paged_step`, each ending
in a device synchronise, as the scheduler's argmax does) for each dispatch
shape the scheduler makes: a 64-token prefill chunk of one sequence against
1024 gathered rows, and one-token decode at batch 1 and 8 against 512
gathered rows (the split-KV decode formulation).  First on the host clock
alone, then under ``torch.profiler``.  One JSON line per shape: host ms per
call with and without the profiler, device kernel ms per call, the device's
idle share (1 - kernel time / wall time without the profiler; one stream,
so kernels do not overlap), the launches of each port kernel per call, and
the kernels by device time with their shares.  Where the profiler records
no device time, the device numbers are null ("not measured").  Needs a GPU;
raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_arch
from repro_torch.core import make_engine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm, time_ssd
from repro_torch.models import transformer as tfm
from repro_torch.serve.kvpool import PagedKVCache
from repro_torch.serve.serve_step import make_paged_step

# name -> (batch, tokens per row, gathered blocks, start position)
SHAPES = {"prefill_chunk": (1, 64, 64, 512),
          "decode_b1": (1, 1, 32, 400),
          "decode_b8": (8, 1, 32, 400)}


def launch_counts() -> dict:
    return {"gemm_fused_fwd": gemm.launches,
            "flash_attention": fa.launches, "flash_decode": fd.launches}


def profile_shape(step, params, pools, name: str, reps: int) -> dict:
    """Profile `reps` paged-step calls of one dispatch shape."""
    b, c, nb, pos = SHAPES[name]
    dev = pools[0]["k"].device
    tables = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    tokens = np.ones((b, c), np.int64)
    start = np.full(b, pos, np.int32)

    def calls() -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            with torch.inference_mode():
                step(params, pools, tables, tokens, start)
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    calls()  # warm
    before = launch_counts()
    wall_s = calls()
    launches = {k: (v - before[k]) / reps for k, v in launch_counts().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_s = calls()
    kernels = time_ssd.kernel_times(prof)
    device_ms = sum(k["ms"] for k in kernels.values()) / reps
    wall_ms = wall_s * 1e3 / reps
    out = {"phase": "profile_lm", "shape": name, "batch": b, "tokens": c,
           "gathered_rows": nb * pools[0]["k"].shape[2], "reps": reps,
           "wall_ms_per_call": wall_ms,
           "profiled_wall_ms_per_call": profiled_s * 1e3 / reps,
           "launches_per_call": launches,
           "tokens_per_s": b * c * reps / wall_s}
    if not kernels:
        out.update(device_ms_per_call=None, idle_share=None, kernels=None)
        return out
    out.update(
        device_ms_per_call=device_ms,
        idle_share=max(0.0, 1.0 - device_ms / wall_ms),
        kernels=[{"name": k[:120], "ms_per_call": t["ms"] / reps,
                  "share": t["ms"] / reps / device_ms}
                 for k, t in list(kernels.items())[:12]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"phase": "device", "nvidia_smi": smi,
                      "name": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    engine = make_engine("cuda")
    cfg = get_arch("qwen2-0.5b")
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=engine.device).manual_seed(args.seed), device=engine.device)
    pools = PagedKVCache(cfg, 256, 16, device=engine.device).pools
    step = make_paged_step(engine, cfg)
    for name in args.shapes:
        print(json.dumps(profile_shape(step, params, pools, name,
                                       args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
