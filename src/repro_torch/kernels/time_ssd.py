"""Device time of the SSD chunk scan at mamba2-1.3b's shapes.

    python3 src/repro_torch/kernels/time_ssd.py [--src DIR] [--label L]
                                                [--prefill]

Builds the kernel from the package under `--src` (default: this
checkout's ``src``) and prints one JSON line.  Pointing `--src` at the
``src`` of another checkout times that version's kernel on the same
inputs, so two versions can be compared within one run on one card.
Needs an NVIDIA GPU.

At the `ssm` phase's prefill (4 x 1000), at 4 x 2048, at batch-1
prefills (`BATCH1`) and at each shape the `ssm_serve` phase gives the
kernel (batch 1, S = each prompt less its last token, `SERVE_LENGTHS`),
all with mamba2-1.3b's 64 heads of 64, one group, N 128 and chunk 256,
and at chip_smoke.py's `SSD_GRID` shapes (keys ``grid:b,s,h,p,g,n,chunk``),
fp32: the median device time in ms of `ssd_scan` over CUDA-graph replays
under every plan (`ssd.PLANS`; a version without plans is timed under its
one launch), the plain version's time and the bound (`ssd_work` at the
FFMA rate and the memory rate of an H100 SXM).  Per shape it names the
plan `plan_for` picks, the fastest plan and the pick's time over the
fastest's; `worst_ratio` is the largest of those, and `serve_mean` the
mean over ssm_serve's eight requests of the pick's and the plain
version's times and of the bound.

With `--prefill`: the `ssm` phase's prefill itself, full-width and
full-depth mamba2-1.3b (seeded random weights) over 4 x 1000 tokens on the
`cuda` engine: its host ms (median of 3 synchronised calls) and, twice,
its device ms by kernel from torch.profiler, summed, with the SSD
launches' and the GEMMs' shares.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCH = dict(h=64, p=64, g=1, n=128, chunk=256)  # mamba2-1.3b's mixer
PREFILL = ((4, 1000), (4, 2048))
BATCH1 = (256, 512, 1000, 2048)  # prompt lengths of one-sequence prefills
# chip_smoke.py's SSD_GRID: (batch, S, H, P, G, N, chunk)
SSD_GRID = ((1, 512, 4, 64, 1, 128, 256), (4, 300, 8, 32, 2, 16, 64),
            (1, 1000, 8, 64, 2, 128, 256), (4, 130, 4, 32, 1, 128, 64),
            (1, 256, 4, 32, 2, 16, 256))
# ssm_serve's eight prompts less their last token (chip_smoke.py's
# requests(cfg, 8, 10, (8, 48), (4, 16)) at mamba2-1.3b's vocabulary)
SERVE_LENGTHS = (38, 16, 19, 9, 32, 43, 27, 16)
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: fp32 FFMA, HBM3


def ssd_work(x, bm, chunk) -> tuple[float, float]:
    """(FLOPs, bytes) that one SSD scan on these inputs needs, 2 FLOPs a
    multiply-add: per chunk of q live rows, the q(q+1)/2 causal (query,
    key) pairs times N for C·Bᵀ once per (batch, group), since every head
    of a group shares it; and per (batch, head) the pairs times P (the
    scores times x̄) and q N P each for the carried state's term and the
    state update.  x, dt, dA, B and C (per group, not per head) read once,
    y and the final state written once."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) / 2
        flops += 2.0 * (g * pairs * n + h * (pairs * p + 2 * q * n * p))
    flops *= b
    es = x.element_size()
    nbytes = (2 * x.numel() * es + 2 * 4.0 * b * s * h
              + 2 * bm.numel() * es + 4.0 * b * h * p * n)
    return flops, nbytes


def mamba_shape(b, s) -> tuple:
    """(batch, S, H, P, G, N, chunk) at mamba2-1.3b's widths."""
    return (b, s, ARCH["h"], ARCH["p"], ARCH["g"], ARCH["n"], ARCH["chunk"])


def operands(b, s, gen, dev, h=ARCH["h"], p=ARCH["p"], g=ARCH["g"],
             n=ARCH["n"]):
    """x, dt, dA, B, C, fp32, from `gen` (mamba2-1.3b's widths unless
    given)."""
    import torch
    x = torch.randn(b, s, h, p, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev) - 0.5)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    bm = torch.randn(b, s, g, n, generator=gen, device=dev)
    cm = torch.randn(b, s, g, n, generator=gen, device=dev)
    return x, dt, (dt * a).contiguous(), bm, cm


def time_shapes(gen, dev) -> dict:
    """Every plan, the plain version and the bound at each shape."""
    from repro_torch.kernels import build, ssd
    from repro_torch.kernels.time_attention import event_ms, graph_ms
    build.build_all(("ssd",))
    plans = getattr(ssd, "PLANS", (None,))
    shapes = {f"{b}x{s}": mamba_shape(b, s) for b, s in (
        *PREFILL, *((1, s) for s in BATCH1),
        *((1, s) for s in sorted(set(SERVE_LENGTHS))))}
    shapes.update((f"grid:{','.join(map(str, c))}", c) for c in SSD_GRID)
    out, worst = {}, 0.0
    for key, (b, s, h, p, g, n, chunk) in shapes.items():
        x, dt, da, bm, cm = operands(b, s, gen, dev, h, p, g, n)
        big = s > chunk
        by_plan = {}
        for plan in plans:
            kw = {} if plan is None else {"plan": plan}
            name = "default" if plan is None else str(tuple(plan))
            by_plan[name] = graph_ms(
                lambda kw=kw: ssd.ssd_scan(x, dt, da, bm, cm, chunk=chunk,
                                           **kw), reps=5 if big else 20)

        def plain():
            return ssd.ssd_scan_plain(x, dt, da, bm, cm, chunk=chunk)

        flops, nbytes = ssd_work(x, bm, chunk)
        ops_ms = flops / PEAK_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"shape": [b, s, h, p, g, n, chunk], "plans": by_plan,
               "plain_ms": (event_ms(plain, reps=2) if big
                            else graph_ms(plain)),
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        if plans[0] is not None:
            pick = str(tuple(ssd.plan_for(*x.shape, *bm.shape[2:], chunk)))
            fastest = min(by_plan, key=by_plan.get)
            ratio = by_plan[pick] / by_plan[fastest]
            row.update(pick=pick, fastest=fastest, ratio=ratio)
            worst = max(worst, ratio)
        row["ms"] = by_plan[row.get("pick", "default")]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out[key] = row
        del x, dt, da, bm, cm
    serve = [out[f"1x{s}"] for s in SERVE_LENGTHS]
    out["serve_mean"] = {k: statistics.mean(r[k] for r in serve)
                         for k in ("ms", "plain_ms", "bound_ms")}
    out["worst_ratio"] = worst
    return out


def device_time_by_kernel(step_fn) -> dict:
    """Device time of one call of `step_fn` by kernel name (the device's
    own events, not the host ops that launched them), from torch.profiler;
    {} when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    return kernel_times(prof)


def kernel_times(prof) -> dict:
    """Device time by kernel name from a finished torch.profiler profile,
    largest first; {} when it recorded no device time."""
    import torch
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = {"ms": us / 1e3, "calls": e.count}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def time_prefill(gen, dev) -> dict:
    """The mamba2-1.3b prefill of PREFILL[0] on the `cuda` engine."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import make_engine
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.serve_step import make_prefill_step
    build.build_all(("gemm", "ssd"))
    cfg = get_arch("mamba2-1.3b")
    params = tfm.init_params(cfg, generator=gen, device=dev)
    inputs = {"tokens": torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, PREFILL[0])).to(dev)}
    prefill = make_prefill_step(make_engine("cuda"), cfg)
    with torch.inference_mode():
        prefill(params, inputs)
        torch.cuda.synchronize()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            prefill(params, inputs)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        runs = [device_time_by_kernel(lambda: prefill(params, inputs))
                for _ in range(2)]

    def share(runs, word):
        return [sum(r["ms"] for name, r in k.items() if word in name)
                for k in runs]

    return {"prefill": {
        "shape": list(PREFILL[0]), "host_ms": statistics.median(host),
        "device_ms": [sum(r["ms"] for r in k.values()) for k in runs],
        "ssd_ms": share(runs, "ssd"), "gemm_ms": share(runs, "gemm")}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[2]))
    parser.add_argument("--label", default="")
    parser.add_argument("--prefill", action="store_true",
                        help="time the mamba2 prefill instead")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_ssd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label, "src": args.src, "smi": smi,
           "device": torch.cuda.get_device_name(0)}
    out.update(time_prefill(gen, dev) if args.prefill
               else time_shapes(gen, dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
