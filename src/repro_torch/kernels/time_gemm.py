"""Device time of every GEMM plan at the port's path shapes.

    python3 src/repro_torch/kernels/time_gemm.py [--bwd | --bmm]

Builds `gemm` and, for each (M, K, N) the paths dispatch, prints one JSON
line: the median device ms of each plan of the shape's regime (regime A
up to 64 rows, B beyond: `gemm.PLANS`) and of torch.matmul (cuBLAS fp32,
TF32 off), each over CUDA-graph replays, fp32 with no epilogue, with the
plan `gemm.plan_for` picks and the fastest.  Up to 64 rows a timed call
cycles over 24 distinct weights (one per layer, as a dispatch does), so
the weights come from device memory and not from the 50 MB L2.  The last
line counts the shapes where the pick is the fastest plan and the worst
ratio of the pick's time to the fastest.  These are the measurements the
rule of `plan_for` was set from.

With ``--bwd``, the backward kernels instead: for the dX and dW of each
``SHAPES_B`` GEMM and of the CNN head (a tied head's dX = dY . E read in
place and its dE = dY^T . X included) and the llama4-scout expert GEMMs'
``bmm_bwd_dx`` / ``bmm_bwd_dw`` (16 experts), every plan of
`gemm.BWD_PLANS` at the split count the path launches
(`ops.default_bwd_tiles`) and torch.matmul / torch.bmm for the same
product (TF32 off), each the median device ms over CUDA-graph replays,
with the pick of `gemm.bwd_plan_for` and the fastest; the last line as
above.  These are the measurements the rule of `bwd_plan_for` was set
from.

With ``--bmm``, the batched forward `bmm_fwd` at llama4-scout's expert
GEMMs (16 experts, 5120 -> 8192 and 8192 -> 5120) over the dispatch rows
the MoE path gives it (``EXPERT_ROWS``: B x capacity, e.g. 32 for a
decode step of 4 slots or a 2 x 128 prefill): every plan of `gemm.PLANS`
(a plan gives every output the same bits at any rows) and torch.bmm (TF32
off), each the median device ms, with the pick of `ops.bmm_plan_for`
and the fastest; the last line as above.  These are the measurements
the rule of `bmm_plan_for` was set from.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

# qwen2-0.5b (q and o, k and v, gate and up, down, the tied head) and
# mamba2-1.3b (wz and wx, wB and wC, wdt, out, the tied head): (K, N,
# transposed w)
LM = [(896, 896, False), (896, 128, False), (896, 4864, False),
      (4864, 896, False), (896, 151936, True)]
SSM = [(2048, 4096, False), (2048, 128, False), (2048, 64, False),
       (4096, 2048, False), (2048, 50288, True)]
ROWS_A = (1, 4, 8, 16, 32, 64)
# DARKNET19_CFG's GEMMs at batch 8, the LM train step (8 x 512 rows), the
# SSM prefill (4 x 1000 rows), llama4-scout's expert GEMM and the paper's
# Figure 3 GEMM
SHAPES_B = ([(401408, 27, 32, False), (100352, 288, 64, False),
             (25088, 576, 128, False), (25088, 128, 64, False),
             (6272, 1152, 256, False), (6272, 256, 128, False),
             (1568, 2304, 512, False), (1568, 512, 256, False)]
            + [(4096, k, n, t) for k, n, t in LM]
            + [(4000, k, n, t) for k, n, t in SSM]
            + [(256, 5120, 8192, False), (2048, 4096, 16384, False)])
LAYERS = 24
# llama4-scout's expert up and down projections: (B, M, K, N)
EXPERT_BMM = [(16, 256, 5120, 8192), (16, 256, 8192, 5120)]
# the MoE path's dispatch rows per expert (B x capacity): decode steps of
# 1, 2, 4 and 8 slots (capacity 8), prefills of 2 x 128, 1 x 1024 and
# 4 x 512 tokens (capacity 16, 80 and 40)
EXPERT_ROWS = (8, 16, 32, 64, 80, 160)


def graph_ms(fn, reps: int, repeats: int = 5) -> float:
    """Median device ms of one call: `reps` calls captured in a CUDA graph,
    replayed `repeats` times between CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bwd_main(torch, dev, gen) -> int:
    """The ``--bwd`` mode: every backward plan at the path's dX and dW
    shapes."""
    from repro_torch.kernels import build, gemm, ops
    build.build_all(("gemm_bwd",))
    cases = []  # (variant, rows, kdim, cols, batch, trans)
    for m, k, n, t in SHAPES_B + [(8, 512, 1000, False)]:
        cases.append(("dx", m, n, k, 1, t))
        cases.append(("dw", n, m, k, 1, t) if t else ("dw", k, m, n, 1, t))
    for b, m, k, n in EXPERT_BMM:
        cases += [("dx", m, n, k, b, False), ("dw", k, m, n, b, False)]
    hits, worst = 0, 1.0
    for variant, rows, kdim, cols, batch, trans in cases:
        splits = ops.default_bwd_tiles(variant, rows, kdim, cols, batch)[3]
        lead = (batch,) if batch > 1 else ()

        def rand(*shape):
            return torch.randn(*lead, *shape, generator=gen, device=dev)

        if variant == "dx":  # dy (M, N) . w^T, w (K, N) or E^T
            a = rand(rows, kdim)
            b = rand(cols, kdim) if not trans else rand(kdim, cols).t()
            fn = gemm.bmm_bwd_dx if batch > 1 else gemm.gemm_bwd_dx
            lib = (a, b.transpose(-1, -2))
        else:  # a^T . b, a (M, rows), b (M, cols): dW, or a tied head's dE
            a, b = rand(kdim, rows), rand(kdim, cols)
            fn = gemm.bmm_bwd_dw if batch > 1 else gemm.gemm_bwd_dw
            lib = (a.transpose(-1, -2), b)
        flops = 2.0 * batch * rows * kdim * cols
        reps = max(1, min(20, round(2e10 / flops)))
        ms = {f"{p.bm}x{p.bn}": graph_ms(
            lambda p=p: fn(a, b, plan=p, splits=splits), reps)
            for p in gemm.BWD_PLANS}
        pick = "{}x{}".format(*gemm.bwd_plan_for(variant, rows, kdim, cols,
                                                 batch))
        best = min(ms, key=ms.get)
        hits += pick == best
        worst = max(worst, ms[pick] / ms[best])
        print(json.dumps({"variant": variant, "shape": [rows, kdim, cols],
                          "batch": batch, "trans_w": trans,
                          "splits": splits, "ms": ms,
                          "cublas_ms": graph_ms(
                              lambda: torch.matmul(*lib), reps),
                          "pick": pick, "best": best}), flush=True)
        del a, b, lib
    print(json.dumps({"shapes": len(cases), "pick_is_fastest": hits,
                      "worst_pick_over_fastest": worst,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def bmm_main(torch, dev, gen) -> int:
    """The ``--bmm`` mode: every forward plan of the batched GEMM at the
    expert shapes of the MoE path."""
    from repro_torch.kernels import build, gemm, ops
    build.build_all(("gemm",))
    hits, worst, n = 0, 1.0, 0
    for b, _, k, nn in EXPERT_BMM:
        w = torch.randn(b, k, nn, generator=gen, device=dev)
        for m in EXPERT_ROWS:
            x = torch.randn(b, m, k, generator=gen, device=dev)
            ms = {"".join(map(str, p)): graph_ms(
                lambda p=p: gemm.bmm_fwd(x, w, plan=p), 3)
                for p in gemm.PLANS}
            pick = "".join(map(str, ops.bmm_plan_for(m, k, nn)))
            best = min(ms, key=ms.get)
            hits += pick == best
            worst = max(worst, ms[pick] / ms[best])
            n += 1
            print(json.dumps({"shape": [b, m, k, nn], "ms": ms,
                              "torch_bmm_ms": graph_ms(
                                  lambda: torch.bmm(x, w), 3),
                              "pick": pick, "best": best}), flush=True)
            del x
        del w
    print(json.dumps({"shapes": n, "pick_is_fastest": hits,
                      "worst_pick_over_fastest": worst,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    if not torch.cuda.is_available():
        print("time_gemm: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    if "--bwd" in sys.argv[1:]:
        return bwd_main(torch, dev, gen)
    if "--bmm" in sys.argv[1:]:
        return bmm_main(torch, dev, gen)
    from repro_torch.kernels import build, gemm
    build.build_all(("gemm",))
    shapes = [(m, k, n, t) for m in ROWS_A for k, n, t in LM + SSM]
    shapes += [(8, 512, 1000, False)] + SHAPES_B
    hits, worst = 0, 1.0
    for m, k, n, trans in shapes:
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(n, k, generator=gen, device=dev).t() if trans else \
            torch.randn(k, n, generator=gen, device=dev)
        copies = LAYERS if m <= gemm.A_MAX_ROWS and n * k < 2**25 else 1
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        regime = "A" if m <= gemm.A_MAX_ROWS else "B"
        reps = max(1, 20 // copies)

        def each(fn):
            return graph_ms(lambda: [fn(wi) for wi in ws], reps) / copies

        ms = {"".join(map(str, p)): each(
            lambda wi, p=p: gemm.gemm_fused_fwd(x, wi, plan=p))
            for p in gemm.PLANS if p.regime == regime}
        pick = "".join(map(str, gemm.plan_for(m, k, n)))
        best = min(ms, key=ms.get)
        hits += pick == best
        worst = max(worst, ms[pick] / ms[best])
        print(json.dumps({"shape": [m, k, n], "trans_w": trans, "ms": ms,
                          "cublas_ms": each(lambda wi: torch.matmul(x, wi)),
                          "pick": pick, "best": best}), flush=True)
        del x, w, ws
    print(json.dumps({"shapes": len(shapes), "pick_is_fastest": hits,
                      "worst_pick_over_fastest": worst,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
