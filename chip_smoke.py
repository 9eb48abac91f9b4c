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
  6. check_bwd  the training kernels against their plain versions on the
              card: the residual forward (y, g = act'(u), racc) over all five
              activations with and without scale and shift, its y bitwise
              equal to the serving launch's; dX and dW (both tiles, with and
              without a split contraction) on MATMUL_CASES and the 12
              DARKNET19 GEMMs at batch 8 in their dX and dW roles, fp32 and
              bf16.  Bars as phase 2; g of relu/leaky is compared away from
              the kink (|u| > 1e-5 max|u|), where two summation orders may
              put u on either side of 0.  Prints each dW's split count.
  7. train    the training main path: full-width DARKNET19_CFG at batch 8,
              three AdamW steps (lr 1e-3, warmup 1) on the `cuda` engine and
              on the `eager` engine from the same state and numpy-seeded
              images.  Step-1 loss <= 1e-5 relative and every step-1
              gradient <= 1e-4 max-relative.  After that, AdamW's division
              by sqrt(nu) carries the rounding of near-zero gradient
              elements into the update undamped, so the trajectories drift
              apart by more than rounding: the losses of steps 2-3 and the
              parameters and moments after step 3 are held to 1e-5 / 1e-4
              or to FLOOR_FACTOR times the drift between two correct fp32
              programs, `eager` on the card and `eager` on the host CPU,
              whichever is larger.  Exactly 12 residual forwards, 11 dX,
              12 dW and the planned reduce passes per step, and no serving
              launch.
  8. timing_train  per backward GEMM of the path at batch 8 and per residual
              forward: kernel, plain, bound and library (torch.matmul) ms;
              the whole train step's ms and images/s on `cuda` and `eager`
              at batch 8 and 64.
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
from repro_torch.kernels.common import ACTIVATIONS, epilogue  # noqa: E402
from repro_torch.serve.frontend import (CNNServingEngine,  # noqa: E402
                                        ImageRequest)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import (cnn_loss_fn,  # noqa: E402
                                          make_cnn_train_step)

MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99)]
BURSTS = (1, 3, 8, 2, 9, 4, 1, 5)
BUCKETS = (1, 2, 4, 8)
FP32_TOL, BF16_TOL = 1e-5, 5e-2
LOGIT_TOL, PROB_TOL = 1e-4, 1e-3
TRAIN_TOL = 1e-4  # gradients, parameters, moments: 12 chained fp32 layers
# After the first step the two trajectories are held to TRAIN_TOL or to
# FLOOR_FACTOR times the distance between two correct fp32 programs (eager
# on the card and on the host), whichever is larger.
FLOOR_FACTOR = 10
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"
SOURCE_BWD = "src/repro_torch/kernels/csrc/gemm_bwd.cu"
REPLACES = "src/repro/kernels/gemm.py:75"  # _gemm_kernel
REPLACES_DX = "src/repro/kernels/gemm.py:251"  # gemm_bwd_dx's pallas_call
REPLACES_DW = "src/repro/kernels/gemm.py:283"  # gemm_bwd_dw's pallas_call
TRAIN_BATCH, TRAIN_STEPS, BIG_BATCH = 8, 3, 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def relmax(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().to(a.device).double()
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


def kink_relmax(got, want, u, act) -> tuple[float, int]:
    """relmax of act'(u) against its plain version.  For relu and leaky the
    derivative steps at u = 0, and two summation orders may put a u within
    rounding of 0 on either side, so those are compared away from the kink
    (|u| > FP32_TOL * max|u|); also returns how many elements differed
    at the kink."""
    if act not in ("relu", "leaky"):
        return relmax(got, want), 0
    away = u.abs() > FP32_TOL * float(u.abs().max())
    return relmax(got[away], want[away]), int(((got != want) & ~away).sum())


def check_res_shape(m, k, n, tiles, gen) -> dict:
    """The residual forward vs its plain version at one shape over dtypes,
    activations and epilogues; y must equal the serving launch's bits."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    max_abs, kink = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        kind = "fp32" if dt == torch.float32 else "bf16"
        tol = FP32_TOL if kind == "fp32" else BF16_TOL
        x, w, scale, shift = operands(m, k, n, dt, gen)
        acc = torch.matmul(x.float(), w.float())
        for act in ACTIVATIONS:
            for sc, sh in ((None, None), (scale, None), (None, shift),
                           (scale, shift)):
                u = epilogue(acc, sc, sh, "linear")
                want = gemm.gemm_fused_res_plain(x, w, sc, sh, act=act)
                for tile in tiles:
                    got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act,
                                              tile=tile, residuals=True)
                    serve = gemm.gemm_fused_fwd(x, w, sc, sh, act=act,
                                                tile=tile)
                    where = (f"{(m, k, n)} {dt} {act} scale={sc is not None}"
                             f" shift={sh is not None} tile={tile}")
                    check(torch.equal(got[0], serve),
                          f"residual y differs from the serving y at {where}")
                    check(all((a is None) == (b is None)
                              for a, b in zip(got, want)),
                          f"residuals present differ at {where}")
                    errs = [relmax(got[0], want[0])]
                    if got[1] is not None:
                        err, n_kink = kink_relmax(got[1], want[1], u, act)
                        errs.append(err)
                        kink += n_kink
                    if got[2] is not None:
                        errs.append(relmax(got[2], want[2]))
                    check(all(math.isfinite(e) for e in errs),
                          f"non-finite residual forward at {where}")
                    check(max(errs) <= tol, f"residual forward vs plain at "
                          f"{where}: {max(errs):.3e} > {tol:g}")
                    worst[kind] = max(worst[kind], max(errs))
                    if kind == "fp32":
                        max_abs = max(max_abs, float(
                            (got[0] - want[0]).abs().max()))
                        if got[2] is not None:
                            max_abs = max(max_abs, float(
                                (got[2] - want[2]).abs().max()))
    return {"kernel": "gemm_fused_fwd_res", "shape": [m, k, n],
            "tiles": list(tiles), "relmax_fp32": worst["fp32"],
            "relmax_bf16": worst["bf16"], "max_abs_err_fp32": max_abs,
            "g_differs_at_kink": kink}


def check_bwd_shape(m, k, n, dx_plans, dw_plans, gen) -> dict:
    """dX = dY W^T and dW = X^T dY vs their plain versions at the forward
    shape (m, k, n), over in/out dtypes and (tile, splits) plans; a dW run
    twice must give the same bits."""
    worst = {"gemm_bwd_dx": {"fp32": 0.0, "bf16": 0.0},
             "gemm_bwd_dw": {"fp32": 0.0, "bf16": 0.0}}
    max_abs = {"gemm_bwd_dx": 0.0, "gemm_bwd_dw": 0.0}
    dev = gen.device
    for in_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=gen, device=dev).to(in_dt)
        w = (torch.randn(k, n, generator=gen, device=dev)
             / math.sqrt(n)).to(in_dt)
        dy = torch.randn(m, n, generator=gen, device=dev).to(in_dt)
        for out_dt in (torch.float32, torch.bfloat16):
            kind = "fp32" if in_dt == out_dt == torch.float32 else "bf16"
            tol = FP32_TOL if kind == "fp32" else BF16_TOL
            for name, fn, plain, a, b, plans in (
                    ("gemm_bwd_dx", gemm.gemm_bwd_dx, gemm.gemm_bwd_dx_plain,
                     dy, w, dx_plans),
                    ("gemm_bwd_dw", gemm.gemm_bwd_dw, gemm.gemm_bwd_dw_plain,
                     x, dy, dw_plans)):
                want = plain(a, b, out_dtype=out_dt)
                for tile, splits in plans:
                    got = fn(a, b, out_dtype=out_dt, tile=tile, splits=splits)
                    where = (f"{name} at {(m, k, n)} {in_dt}->{out_dt} "
                             f"tile={tile} splits={splits}")
                    check(bool(torch.isfinite(got).all()),
                          f"non-finite {where}")
                    err = relmax(got, want)
                    check(err <= tol, f"{where}: {err:.3e} > {tol:g}")
                    worst[name][kind] = max(worst[name][kind], err)
                    if kind == "fp32":
                        max_abs[name] = max(max_abs[name], float(
                            (got - want).abs().max()))
                    if name == "gemm_bwd_dw":
                        check(torch.equal(got, fn(a, b, out_dtype=out_dt,
                                                  tile=tile, splits=splits)),
                              f"two runs of {where} differ")
    return {"shape": [m, k, n], "dx_plans": dx_plans, "dw_plans": dw_plans,
            "dw_splits": [gemm.split_chunk(m, s)[1] for _, s in dw_plans],
            "relmax": worst, "max_abs_err_fp32": max_abs}


def bwd_plans(m, k, n) -> tuple[list, list]:
    """The path's (tile, splits) plans of the backward GEMMs of the forward
    GEMM (m, k, n)."""
    dx = ops.default_bwd_tiles("dx", m, n, k)
    dw = ops.default_bwd_tiles("dw", k, m, n)
    return [(dx[0], dx[3])], [(dw[0], dw[3])]


def grads_of(net, batch) -> tuple[torch.Tensor, dict]:
    """cnn_loss_fn and its gradient with respect to every parameter."""
    params = dict(net.named_parameters())
    loss = cnn_loss_fn(net, *batch)
    return loss, dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def host_ms(fn, reps: int = 5) -> float:
    """Median host time of `fn()` followed by a device synchronise, after
    one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def bound(flops, nbytes, peak_flops, peak_bw) -> tuple[float, str]:
    """(least ms, what bounds it) for `flops` FFMA-rate operations and
    `nbytes` moved once each."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


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

    # --------------------------------------------------------- 6. check_bwd
    bwd_max_abs = {"gemm_bwd_dx": 0.0, "gemm_bwd_dw": 0.0}
    res_max_abs = 0.0
    forced = [(t, s) for t in gemm.TILES for s in (1, 3)]
    for m, k, n in MATMUL_CASES:
        emit("check_bwd", **check_res_shape(m, k, n, gemm.TILES, cgen))
        emit("check_bwd", **check_bwd_shape(m, k, n, forced, forced, cgen))
    for g in path_gemms(net, TRAIN_BATCH):
        m, k, n = g["m"], g["k"], g["n"]
        res = check_res_shape(m, k, n, (ops.default_tiles(m, k, n)[0],), cgen)
        res_max_abs = max(res_max_abs, res["max_abs_err_fp32"])
        emit("check_bwd", batch=TRAIN_BATCH, layer=g["layer"], **res)
        res = check_bwd_shape(m, k, n, *bwd_plans(m, k, n), cgen)
        for key in bwd_max_abs:
            bwd_max_abs[key] = max(bwd_max_abs[key],
                                   res["max_abs_err_fp32"][key])
        emit("check_bwd", batch=TRAIN_BATCH, layer=g["layer"], **res)
    torch.cuda.synchronize()

    # ------------------------------------------------------------- 7. train
    tgen = torch.Generator().manual_seed(2)
    net_c = Network(DARKNET19_CFG, engine, generator=tgen)
    randomize_bn(net_c, tgen)
    net_e = Network(DARKNET19_CFG, eager)
    net_h = Network(DARKNET19_CFG, make_engine("eager", device="cpu"))
    net_e.load_state_dict(net_c.state_dict())
    net_h.load_state_dict(net_c.state_dict())
    rng = np.random.default_rng(3)
    host_batches = [(torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, *net_c.in_shape)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)))
        for _ in range(TRAIN_STEPS)]
    batches = [(x.to(dev), y.to(dev)) for x, y in host_batches]
    loss_c1, grads_c = grads_of(net_c, batches[0])
    loss_e1, grads_e = grads_of(net_e, batches[0])
    _, grads_h = grads_of(net_h, host_batches[0])
    grad_err = {k: relmax(grads_c[k], grads_e[k]) for k in grads_e}
    grad_floor = {k: relmax(grads_h[k], grads_e[k]) for k in grads_e}
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    train_gemms = path_gemms(net_c, TRAIN_BATCH)
    want_step = {"gemm_fused_fwd": 0, "gemm_fused_fwd_res": 12,
                 "gemm_bwd_dx": 11, "gemm_bwd_dw": 12, "gemm_bwd_reduce": 0}
    for i, g in enumerate(train_gemms):
        dx_plans, dw_plans = bwd_plans(g["m"], g["k"], g["n"])
        want_step["gemm_bwd_reduce"] += ((i > 0 and dx_plans[0][1] > 1)
                                         + (dw_plans[0][1] > 1))
    runs = {}
    for label, tnet, tbatches in (("cuda", net_c, batches),
                                  ("eager", net_e, batches),
                                  ("host", net_h, host_batches)):
        step = make_cnn_train_step(tnet, ocfg)
        state = opt.adamw_init(dict(tnet.named_parameters()))
        per_step, losses = [], []
        gemm.reset_launches()
        backends.reset_dispatch_counts()
        for batch in tbatches:  # ---- for "cuda": the training main path
            before = gemm.launch_counts()
            state, metrics = step(state, batch)
            after = gemm.launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            losses.append(metrics["loss"].item())
        runs[label] = {"step": step, "state": state, "losses": losses,
                       "per_step": per_step,
                       "launches": gemm.launch_counts(),
                       "dispatch": backends.dispatch_counts(),
                       "params": dict(tnet.named_parameters())}
    torch.cuda.synchronize()
    cu, ea, ho = runs["cuda"], runs["eager"], runs["host"]
    train_launches = cu["launches"]

    def drift(run) -> dict:
        """Loss, parameter and moment distance of `run` from eager."""
        return {"loss": [abs(a - b) / abs(b)
                         for a, b in zip(run["losses"], ea["losses"])],
                "params": {k: relmax(run["params"][k], p)
                           for k, p in ea["params"].items()},
                "moments": {f"{m}.{k}": relmax(run["state"][m][k],
                                               ea["state"][m][k])
                            for m in ("mu", "nu") for k in ea["params"]}}

    err, floor = drift(cu), drift(ho)
    worst = {key: max(err[key].values()) for key in ("params", "moments")}
    worst_floor = {key: max(floor[key].values())
                   for key in ("params", "moments")}
    emit("train", cfg="DARKNET19_CFG", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         losses_cuda=cu["losses"], losses_eager=ea["losses"],
         losses_host=ho["losses"], loss_rel_err=err["loss"],
         loss_rel_floor=floor["loss"],
         step1_loss_rel_err=abs(loss_c1.item() - loss_e1.item())
         / abs(loss_e1.item()),
         grad_relmax_worst=max(grad_err.values()),
         grad_floor_worst=max(grad_floor.values()),
         param_relmax_worst=worst["params"],
         param_floor_worst=worst_floor["params"],
         moment_relmax_worst=worst["moments"],
         moment_floor_worst=worst_floor["moments"],
         floor_factor=FLOOR_FACTOR, grad_relmax=grad_err,
         param_relmax=err["params"], param_floor=floor["params"],
         launches_per_step=cu["per_step"], launches=train_launches,
         want_per_step=want_step,
         eager_launches=ea["launches"], host_launches=ho["launches"],
         dispatch={f"{b}.{o}": c for (b, o), c in cu["dispatch"].items()})
    check(all(math.isfinite(x) for x in cu["losses"]), "non-finite loss")
    check(err["loss"][0] <= FP32_TOL,
          f"step-1 loss cuda vs eager {err['loss'][0]:.3e} > {FP32_TOL:g}")
    check(len(grad_err) == 57, f"{len(grad_err)} gradients, want 57")
    check(max(grad_err.values()) <= TRAIN_TOL,
          f"step-1 gradient cuda vs eager {max(grad_err.values()):.3e}")
    for i, (e, f) in enumerate(zip(err["loss"], floor["loss"])):
        check(e <= max(FP32_TOL, FLOOR_FACTOR * f),
              f"step-{i + 1} loss cuda vs eager {e:.3e}, host vs eager "
              f"{f:.3e}")
    for key in ("params", "moments"):
        check(worst[key] <= max(TRAIN_TOL, FLOOR_FACTOR * worst_floor[key]),
              f"{key} after {TRAIN_STEPS} steps: cuda vs eager "
              f"{worst[key]:.3e}, host vs eager {worst_floor[key]:.3e}")
    check(all(c == want_step for c in cu["per_step"]),
          f"launches per step {cu['per_step']}, want {want_step}")
    check(sum(ea["launches"].values()) + sum(ho["launches"].values()) == 0,
          "the eager engines launched a kernel of the port")
    check(cu["dispatch"] == {("cuda", "conv2d"): 11 * TRAIN_STEPS,
                             ("cuda", "matmul"): TRAIN_STEPS},
          f"train path dispatches {cu['dispatch']}")
    del net_h, grads_h, host_batches

    # ------------------------------------------------------ 8. timing_train
    tt = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                 "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
          for name in ("gemm_fused_fwd_res", "gemm_bwd_dx", "gemm_bwd_dw")}

    def record(name, layer, shape, flops, nbytes, fn, plain, library,
               **extra):
        ms, plain_ms, library_ms = cuda_ms(fn), cuda_ms(plain), cuda_ms(
            library)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        row = tt[name]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += library_ms
        row["bound_ms"] += bound_ms
        row["ops_ms"] += flops / peak_flops * 1e3
        row["bytes_ms"] += nbytes / peak_bw * 1e3
        emit("timing_train", kernel=name, batch=TRAIN_BATCH, layer=layer,
             shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             tflops=flops / ms / 1e9, bound_share=bound_ms / ms, **extra)

    for i, g in enumerate(train_gemms):
        m, k, n, act = g["m"], g["k"], g["n"], g["act"]
        x, w, scale, shift = operands(m, k, n, torch.float32, cgen)
        dy = torch.randn(m, n, generator=cgen, device=dev)
        sc = scale if g["scale"] else None
        sh = shift if g["shift"] else None
        tile = ops.default_tiles(m, k, n)[0]
        res_out = 1 + (act != "linear") + int(g["scale"])
        record("gemm_fused_fwd_res", g["layer"], [m, k, n], 2.0 * m * k * n,
               4.0 * (m * k + k * n + res_out * m * n
                      + n * (int(g["scale"]) + int(g["shift"]))),
               lambda: gemm.gemm_fused_fwd(x, w, sc, sh, act=act, tile=tile,
                                           residuals=True),
               lambda: gemm.gemm_fused_res_plain(x, w, sc, sh, act=act),
               lambda: torch.matmul(x, w), tile=tile)
        (dx_plan,), (dw_plan,) = bwd_plans(m, k, n)
        if i > 0:  # the first layer's input is the image: no dX
            record("gemm_bwd_dx", g["layer"], [m, n, k], 2.0 * m * k * n,
                   4.0 * (m * n + k * n + m * k),
                   lambda: gemm.gemm_bwd_dx(dy, w, tile=dx_plan[0],
                                            splits=dx_plan[1]),
                   lambda: gemm.gemm_bwd_dx_plain(dy, w),
                   lambda: torch.matmul(dy, w.t()), tile=dx_plan[0],
                   splits=dx_plan[1])
        record("gemm_bwd_dw", g["layer"], [k, m, n], 2.0 * m * k * n,
               4.0 * (m * k + m * n + k * n),
               lambda: gemm.gemm_bwd_dw(x, dy, tile=dw_plan[0],
                                        splits=dw_plan[1]),
               lambda: gemm.gemm_bwd_dw_plain(x, dy),
               lambda: torch.matmul(x.t(), dy), tile=dw_plan[0],
               splits=dw_plan[1])
    emit("timing_train_total", batch=TRAIN_BATCH, smi=smi, **tt)
    del x, w, dy
    def run_step(label, batch):
        runs[label]["state"], _ = runs[label]["step"](runs[label]["state"],
                                                      batch)

    steps = {}
    for batch_size in (TRAIN_BATCH, BIG_BATCH):
        images = torch.randn((batch_size, *net_c.in_shape), generator=cgen,
                             device=dev)
        labels = torch.randint(0, 1000, (batch_size,), generator=cgen,
                               device=dev)
        for label in ("cuda", "eager"):
            torch.cuda.reset_peak_memory_stats(dev)
            ms = host_ms(lambda: run_step(label, (images, labels)))
            steps[f"{label}_b{batch_size}"] = {
                "ms": ms, "images_per_s": batch_size / ms * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del images, labels
    # The cuda step at TRAIN_BATCH in two parts: forward + backward, then
    # clipping + AdamW over the 57 parameter tensors.
    grads = grads_of(net_c, batches[0])[1]
    parts = {"forward_backward_ms": host_ms(lambda: grads_of(net_c,
                                                             batches[0])),
             "optimizer_ms": host_ms(lambda: opt.adamw_update(
                 ocfg, opt.clip_by_global_norm(grads, ocfg.clip_norm)[0],
                 cu["state"], cu["params"]))}
    kernel_ms = sum(row["ms"] for row in tt.values())
    emit("timing_train_step", smi=smi, steps=steps, batch=TRAIN_BATCH,
         kernel_ms=kernel_ms, **parts,
         kernel_share=kernel_ms / steps[f"cuda_b{TRAIN_BATCH}"]["ms"])

    def kernel_entry(name, source, replaces, launches, max_abs_err, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "checked": True, "launches": launches,
                "max_abs_err": max_abs_err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": ("operations" if row["ops_ms"] >= row["bytes_ms"]
                             else "bytes"),
                "library_ms": row["library_ms"]}

    print(json.dumps({"kernels": [
        kernel_entry("gemm_fused_fwd", SOURCE, REPLACES, main_launches,
                     path_max_abs, totals),
        kernel_entry("gemm_fused_fwd_res", SOURCE, REPLACES,
                     train_launches["gemm_fused_fwd_res"], res_max_abs,
                     tt["gemm_fused_fwd_res"]),
        kernel_entry("gemm_bwd_dx", SOURCE_BWD, REPLACES_DX,
                     train_launches["gemm_bwd_dx"],
                     bwd_max_abs["gemm_bwd_dx"], tt["gemm_bwd_dx"]),
        kernel_entry("gemm_bwd_dw", SOURCE_BWD, REPLACES_DW,
                     train_launches["gemm_bwd_dw"],
                     bwd_max_abs["gemm_bwd_dw"], tt["gemm_bwd_dw"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
