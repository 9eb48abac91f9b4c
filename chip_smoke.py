#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; imports nothing of jax or of the
JAX package.  Every phase prints one JSON line; any failure raises and the
script exits non-zero.  Phases:

  1. device   the card's name, capability (must be 9.0), its name and power
              limit from nvidia-smi; then the kernels are built from the
              sources in this checkout (build seconds, ptxas report).
  2. check    the fused-GEMM kernel against its plain PyTorch version on the
              card: the MATMUL_CASES grid of tests/test_grad_conformance.py
              (both tile sizes) and the 12 DARKNET19 GEMM shapes at batch 1
              and 8, all five activations, with and without scale/shift,
              fp32 and bf16 operands and outputs.  Max-relative error
              <= 1e-5 when everything is fp32, <= 5e-2 with bf16.
  3. network  DARKNET19_CFG at 224x224, full width, seeded init with
              randomized BN statistics: the `cuda` engine against the
              `eager` engine on the card (pre-softmax logits <= 1e-4
              max-relative, probabilities <= 1e-3), the built op plan, and
              exactly 12 kernel launches per forward.
  4. serve    the main path: a CNNServingEngine over compile_cache(buckets=
              (1, 2, 4, 8)) answers the ragged bursts (1, 3, 8, 2, 9, 4, 1,
              5) of examples/serve_cnn.py, 33 requests, with the launch count
              set to 0 just before and read just after.  Every request
              completes, builds equal compiled buckets, padded-bucket rows
              are bitwise equal to an exact-batch run; images/s and latency.
  5. timing   per DARKNET19 GEMM shape at batch 8: the kernel's median time
              (CUDA events), the plain version's, torch.matmul's (cuBLAS
              fp32, TF32 off, no epilogue: `library_ms`) and the bound.
Then the kernels line, and last the result line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.darknet_ref import DARKNET19_CFG  # noqa: E402
from repro_torch.core import backends, make_engine  # noqa: E402
from repro_torch.core.darknet.network import Network  # noqa: E402
from repro_torch.kernels import build, gemm, ops  # noqa: E402
from repro_torch.kernels.common import ACTIVATIONS  # noqa: E402
from repro_torch.serve.frontend import (CNNServingEngine,  # noqa: E402
                                        ImageRequest)

MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99)]
BURSTS = (1, 3, 8, 2, 9, 4, 1, 5)
BUCKETS = (1, 2, 4, 8)
FP32_TOL, BF16_TOL = 1e-5, 5e-2
LOGIT_TOL, PROB_TOL = 1e-4, 1e-3
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"
REPLACES = "src/repro/kernels/gemm.py:75"  # _gemm_kernel


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def relmax(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def card_peaks(name: str) -> tuple[float, float]:
    """(fp32 FFMA FLOP/s, memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12  # SXM


def path_gemms(net: Network, batch: int) -> list[dict]:
    """The GEMMs one forward of `net` runs at `batch`, in layer order:
    (m, k, n) and the fused epilogue, from the layer plan."""
    out, hwc = [], net.in_shape
    for p in net.plans:
        o = p.options
        if p.type == "convolutional":
            size = o.get("size", 3)
            bn = bool(o.get("batch_normalize", 0))
            out.append({"layer": p.index,
                        "m": batch * p.out_shape[0] * p.out_shape[1],
                        "k": size * size * hwc[2], "n": p.out_shape[2],
                        "act": o.get("activation", "leaky"),
                        "scale": bn, "shift": True})
        elif p.type == "connected":
            out.append({"layer": p.index, "m": batch,
                        "k": math.prod(hwc), "n": p.out_shape[2],
                        "act": o.get("activation", "linear"),
                        "scale": False, "shift": True})
        hwc = p.out_shape
    return out


def randomize_bn(net: Network, gen: torch.Generator) -> None:
    """Non-trivial BN statistics: the init values 1/0/0/1 would hide a
    wrong fold."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            n = p.shape[0]
            if name.endswith(".gamma") or name.endswith(".var"):
                p.copy_(torch.rand(n, generator=gen) + 0.5)
            elif name.endswith(".beta") or name.endswith(".mean"):
                p.copy_(torch.randn(n, generator=gen) * 0.1)


def operands(m, k, n, dtype, gen):
    """GEMM operands drawn on the card from the CUDA generator `gen`."""
    dev = gen.device
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=dev)
         / math.sqrt(k)).to(dtype)
    scale = torch.rand(n, generator=gen, device=dev) + 0.5
    shift = torch.randn(n, generator=gen, device=dev) * 0.1
    return x, w, scale, shift


def check_shape(m, k, n, tiles, gen) -> dict:
    """Kernel vs plain at one shape over dtypes, activations, epilogues."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    for in_dt in (torch.float32, torch.bfloat16):
        x, w, scale, shift = operands(m, k, n, in_dt, gen)
        for out_dt in (torch.float32, torch.bfloat16):
            kind = ("fp32" if in_dt == out_dt == torch.float32 else "bf16")
            tol = FP32_TOL if kind == "fp32" else BF16_TOL
            for act in ACTIVATIONS:
                for sc, sh in ((None, None), (scale, None), (None, shift),
                               (scale, shift)):
                    want = gemm.gemm_fused_plain(x, w, sc, sh, act=act,
                                                 out_dtype=out_dt)
                    for tile in tiles:
                        got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act,
                                                  out_dtype=out_dt, tile=tile)
                        check(bool(torch.isfinite(got).all()),
                              f"non-finite kernel output at {(m, k, n)}")
                        err = relmax(got, want)
                        check(err <= tol, f"kernel vs plain at {(m, k, n)} "
                              f"{in_dt}->{out_dt} {act} scale={sc is not None}"
                              f" shift={sh is not None} tile={tile}: "
                              f"{err:.3e} > {tol:g}")
                        worst[kind] = max(worst[kind], err)
                        if kind == "fp32":
                            max_abs = max(max_abs, float(
                                (got - want).abs().max()))
    return {"shape": [m, k, n], "tiles": list(tiles),
            "relmax_fp32": worst["fp32"], "relmax_bf16": worst["bf16"],
            "max_abs_err_fp32": max_abs}


def cuda_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `reps` back-to-back calls,
    by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # ------------------------------------------------------------ 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    check(cap == (9, 0), f"need a Hopper card (capability 9.0), got {cap}")
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs
             for ln in lib.with_name(lib.name + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, libraries=[p.name for p in libs],
         ptxas=ptxas)

    engine = make_engine("cuda")  # also turns TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    gen = torch.Generator().manual_seed(0)
    net = Network(DARKNET19_CFG, engine, generator=gen)
    randomize_bn(net, gen)
    cgen = torch.Generator(device=dev).manual_seed(1)
    peak_flops, peak_bw = card_peaks(name)

    # ------------------------------------------------------------- 2. check
    path_max_abs = 0.0
    for m, k, n in MATMUL_CASES:
        emit("check", **check_shape(m, k, n, gemm.TILES, cgen))
    for batch in (1, 8):
        for g in path_gemms(net, batch):
            tiles = (ops.default_tiles(g["m"], g["k"], g["n"])[0],)
            res = check_shape(g["m"], g["k"], g["n"], tiles, cgen)
            path_max_abs = max(path_max_abs, res["max_abs_err_fp32"])
            emit("check", batch=batch, layer=g["layer"], **res)
    torch.cuda.synchronize()

    # ----------------------------------------------------------- 3. network
    logits_cfg = DARKNET19_CFG.replace("[softmax]", "")
    eager = make_engine("eager", device=dev)
    lg_cuda = Network(logits_cfg, engine)
    lg_eager = Network(logits_cfg, eager)
    prob_eager = Network(DARKNET19_CFG, eager)
    for other in (lg_cuda, lg_eager, prob_eager):
        other.load_state_dict(net.state_dict())
    x = torch.randn((2, *net.in_shape), generator=gen).to(dev)
    with torch.inference_mode():
        z_cuda, z_eager = lg_cuda(x), lg_eager(x)
        before = gemm.launches
        p_cuda = net(x)
        launches_per_forward = gemm.launches - before
        p_eager = prob_eager(x)
    torch.cuda.synchronize()
    check(tuple(z_cuda.shape) == (2, 1000), f"logits {tuple(z_cuda.shape)}")
    check(bool(torch.isfinite(z_cuda).all() and torch.isfinite(p_cuda).all()),
          "non-finite network output")
    logit_err, prob_err = relmax(z_cuda, z_eager), relmax(p_cuda, p_eager)
    check(logit_err <= LOGIT_TOL, f"logits cuda vs eager {logit_err:.3e}")
    check(prob_err <= PROB_TOL, f"probabilities cuda vs eager {prob_err:.3e}")
    check(bool(torch.allclose(p_cuda.sum(-1), torch.ones(2, device=dev),
                              atol=1e-5)), "probabilities do not sum to 1")
    check(launches_per_forward == 12,
          f"{launches_per_forward} kernel launches per forward, want 12")
    built = net.compile(2)
    want_plan = {("cuda", "conv2d"): 11, ("cuda", "matmul"): 1}
    check(built.op_counts == want_plan, f"op plan {built.op_counts}")
    check(built.trace_count == 1, f"{built.trace_count} builds")
    emit("network", cfg="DARKNET19_CFG", batch=2, logits_relmax=logit_err,
         probs_relmax=prob_err, logits_max_abs=float(z_cuda.abs().max()),
         launches_per_forward=launches_per_forward,
         op_counts={f"{b}.{o}": c for (b, o), c in built.op_counts.items()})

    # ------------------------------------------------------------- 4. serve
    cache = net.compile_cache(buckets=BUCKETS)
    server = CNNServingEngine(cache)
    rng = np.random.default_rng(0)
    h, w, c = net.in_shape
    bursts = []
    rid = 0
    for size in BURSTS:
        bursts.append([ImageRequest(rid=rid + i, image=rng.standard_normal(
            (h, w, c)).astype(np.float32)) for i in range(size)])
        rid += size
    gemm.reset_launches()
    backends.reset_dispatch_counts()
    for reqs in bursts:  # ---- the main path, driven once
        server.run(reqs)
    main_launches = gemm.launches
    main_dispatch = backends.dispatch_counts()
    st = server.stats()
    cs = st["cache"]
    check(main_launches > 0, "the main path launched no kernel")
    check(set(main_dispatch) == {("cuda", "conv2d"), ("cuda", "matmul")},
          f"main path dispatches {main_dispatch}")
    check(all(r.done and r.result is not None for b in bursts for r in b),
          "a request did not complete")
    check(st["requests"]["completed"] == rid == 33,
          f"{st['requests']['completed']} of {rid} requests completed")
    check(cs["misses"] == len(cs["compiled"]) == cs["traces"],
          f"builds {cs['misses']} / traces {cs['traces']} for "
          f"{len(cs['compiled'])} buckets")
    padded_rows = 0
    with torch.inference_mode():
        for reqs in bursts:
            for i in range(0, len(reqs), BUCKETS[-1]):
                chunk = reqs[i:i + BUCKETS[-1]]
                xb = torch.from_numpy(np.stack([r.image for r in chunk]))
                exact = net(xb.to(dev)).cpu().numpy()
                served = np.stack([r.result for r in chunk])
                check(np.array_equal(exact, served),
                      f"served rows differ from an exact batch of "
                      f"{len(chunk)}")
                if cache.bucket_for(len(chunk)) != len(chunk):
                    padded_rows += len(chunk)
    per_bucket = {}
    for b in BUCKETS:
        prof = cache.get(b).profile(reps=10)
        per_bucket[str(b)] = {"per_call_ms": prof["per_call_s"] * 1e3,
                              "images_per_s": b / prof["per_call_s"]}
    lat = st["latency_s"]
    emit("serve", requests=rid, completed=st["requests"]["completed"],
         steps=st["steps"], images_per_s=st["throughput"],
         p50_ms=lat["p50"] * 1e3, p99_ms=lat["p99"] * 1e3,
         buckets=list(cs["compiled"]), builds=cs["misses"],
         dispatches={str(k): v for k, v in cs["dispatches"].items()},
         pad_waste=cs["pad_waste"], bitwise_padded_rows=padded_rows,
         launches=main_launches, per_bucket=per_bucket)

    # ------------------------------------------------------------ 5. timing
    gemms = path_gemms(net, 8)
    logged = [backends.gemm_dims(r["op"], r["shapes"])
              for r in cache.get(8).op_log]
    check(logged == [(g["m"], g["k"], g["n"]) for g in gemms],
          f"planned GEMMs differ from the dispatched ones: {logged}")
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "ops_ms": 0.0, "bytes_ms": 0.0}
    for g in gemms:
        m, k, n = g["m"], g["k"], g["n"]
        x, w, scale, shift = operands(m, k, n, torch.float32, cgen)
        sc = scale if g["scale"] else None
        sh = shift if g["shift"] else None
        tile = ops.default_tiles(m, k, n)[0]
        ms = cuda_ms(lambda: gemm.gemm_fused_fwd(x, w, sc, sh, act=g["act"],
                                                 tile=tile))
        plain_ms = cuda_ms(lambda: gemm.gemm_fused_plain(x, w, sc, sh,
                                                         act=g["act"]))
        library_ms = cuda_ms(lambda: torch.matmul(x, w))
        flops = 2.0 * m * k * n
        nbytes = 4.0 * (m * k + k * n + m * n + n * (int(g["scale"])
                                                     + int(g["shift"])))
        ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bound_ms),
                         ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            totals[key] += val
        emit("timing", batch=8, layer=g["layer"], shape=[m, k, n],
             act=g["act"], tile=tile, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             tflops=flops / ms / 1e9, bound_share=bound_ms / ms)
    emit("timing_total", batch=8, gemms=len(gemms), smi=smi, **totals)

    print(json.dumps({"kernels": [{
        "name": "gemm_fused_fwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "checked": True, "launches": main_launches,
        "max_abs_err": path_max_abs, "ms": totals["ms"],
        "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if totals["ops_ms"] >= totals["bytes_ms"]
                     else "bytes"),
        "library_ms": totals["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
