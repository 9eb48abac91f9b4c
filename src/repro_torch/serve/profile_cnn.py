"""Where the time of one served CNN batch goes, on the card.

    PYTHONPATH=src python3 -m repro_torch.serve.profile_cnn [--reps 20]

Builds DARKNET19_CFG (224 x 224, full width, seeded weights) on the `cuda`
engine, warms a `CompileCache` at each bucket, and runs `--reps` bucket
dispatches of `CompileCache.run` (each ending in a device synchronise, as
`CNNServingEngine.step` does): first on the host clock alone, then again
under ``torch.profiler``.  One JSON line per bucket: host wall time per
call without and with the profiler (the profiler slows the host), device
kernel time per call, the device's idle share (1 - kernel time / wall
time without the profiler; the path runs on one stream, so its kernels
do not overlap), and the kernels by device time, with the share each
takes.  Where the profiler records no device time, the device numbers are
printed as null ("not measured").  Needs a GPU; raises without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.darknet_ref import DARKNET19_CFG
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.core.engine import synchronize
from repro_torch.kernels import gemm


def _device_us(evt) -> float:
    # `device_time_total` in recent PyTorch, `cuda_time_total` before it.
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_kernels(prof) -> collections.Counter:
    """Device microseconds by kernel name from a finished profiler.  Host
    operators also report the device time of the kernels they launched;
    only the device-side events (kernels, copies, fills) are counted, so
    nothing is counted twice."""
    kernels = collections.Counter()
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA"):
            kernels[evt.key] += us
    return kernels


def profile_bucket(cache, bucket: int, reps: int, seed: int) -> dict:
    """Profile `reps` dispatches of a `bucket`-image batch through `cache`."""
    net = cache.net
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((bucket, *net.in_shape), generator=gen).to(
        net.engine.device)

    def calls() -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            cache.run(x)
            synchronize(net.engine.device)
        return time.perf_counter() - t0

    calls()  # warm
    before = gemm.launches
    wall_s = calls()
    launches = gemm.launches - before
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_s = calls()
    kernels = device_kernels(prof)
    device_us = sum(kernels.values())
    wall_ms = wall_s * 1e3 / reps
    out = {"phase": "profile", "bucket": bucket, "reps": reps,
           "wall_ms_per_call": wall_ms,
           "profiled_wall_ms_per_call": profiled_s * 1e3 / reps,
           "gemm_launches_per_call": launches / reps,
           "images_per_s": bucket * reps / wall_s}
    if device_us == 0:
        out.update(device_ms_per_call=None, idle_share=None, kernels=None)
        return out
    device_ms = device_us / 1e3 / reps
    out.update(
        device_ms_per_call=device_ms,
        idle_share=max(0.0, 1.0 - device_ms / wall_ms),
        kernels=[{"name": k[:120], "ms_per_call": us / 1e3 / reps,
                  "share": us / device_us}
                 for k, us in kernels.most_common(12)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"phase": "device", "nvidia_smi": smi,
                      "name": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    net = Network(DARKNET19_CFG, make_engine("cuda"),
                  generator=torch.Generator().manual_seed(args.seed))
    cache = net.compile_cache(buckets=args.buckets).warmup()
    for b in args.buckets:
        print(json.dumps(profile_bucket(cache, b, args.reps, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
