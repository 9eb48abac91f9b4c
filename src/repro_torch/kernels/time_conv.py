"""Device time of the direct convolution at the DARKNET19 layers.

    python3 src/repro_torch/kernels/time_conv.py [--src DIR] [--label L]

Builds the kernel from the package under `--src` (default: this
checkout's ``src``) and prints one JSON line.  Pointing `--src` at the
``src`` of another checkout times that version's kernel on the same
inputs, so two versions can be compared within one run on one card.
Needs an NVIDIA GPU.

At each of the 11 convolutions of DARKNET19_CFG at batch 8 (`LAYERS`),
fp32 and bf16, on inputs padded outside: the median device time in ms of
`conv2d_direct` over CUDA-graph replays under every plan
(`conv_direct.PLANS`; a version without plans is timed under its one
launch) and of cuDNN's ``F.conv2d`` on the same NHWC storage (TF32 off),
the library time.  Per layer it names the plan `plan_for` picks, the
fastest plan and the pick's time over the fastest's; `worst_ratio` is the
largest of those, and `total` sums the picks' and cuDNN's times.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BATCH = 8
# DARKNET19_CFG's convolutions (chip_smoke.py's path_convs): layer index,
# input (H, W, Cin), Cout and kernel size, stride 1, padding size // 2
LAYERS = ((0, 224, 3, 32, 3), (2, 112, 32, 64, 3), (4, 56, 64, 128, 3),
          (5, 56, 128, 64, 1), (6, 56, 64, 128, 3), (8, 28, 128, 256, 3),
          (9, 28, 256, 128, 1), (10, 28, 128, 256, 3),
          (12, 14, 256, 512, 3), (13, 14, 512, 256, 1),
          (14, 14, 256, 512, 3))


def time_layers(gen, dev) -> dict:
    """Every plan and cuDNN at LAYERS, fp32 and bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, conv_direct
    from repro_torch.kernels.time_attention import graph_ms
    build.build_all(("conv_direct",))
    plans = getattr(conv_direct, "PLANS", (None,))
    out, worst = {}, 0.0
    total = {"fp32": {"pick": 0.0, "library": 0.0},
             "bf16": {"pick": 0.0, "library": 0.0}}
    for layer, hw, cin, cout, k in LAYERS:
        x = torch.randn(BATCH, hw, hw, cin, generator=gen, device=dev)
        w = torch.randn(k, k, cin, cout, generator=gen, device=dev) / (
            k * k * cin) ** 0.5
        p = k // 2
        for kind, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            xp = F.pad(x, (0, 0, p, p, p, p)).to(dtype)
            wd = w.to(dtype)
            xn = xp.permute(0, 3, 1, 2)  # NCHW view of the NHWC storage
            wn = wd.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            by_plan = {}
            for plan in plans:
                kw = {} if plan is None else {"plan": plan}
                name = "default" if plan is None else str(tuple(plan))
                by_plan[name] = graph_ms(
                    lambda kw=kw: conv_direct.conv2d_direct(xp, wd, **kw))
            row = {"layer": layer, "dtype": kind,
                   "shape": [BATCH, hw, hw, cin, cout, k], "plans": by_plan,
                   "library_ms": graph_ms(lambda: F.conv2d(xn, wn))}
            if plans[0] is not None:
                pick = str(tuple(conv_direct.plan_for(*xp.shape, k, k, cout,
                                                      dtype=dtype)))
                fastest = min(by_plan, key=by_plan.get)
                ratio = by_plan[pick] / by_plan[fastest]
                row.update(pick=pick, pick_ms=by_plan[pick], fastest=fastest,
                           ratio=ratio)
                worst = max(worst, ratio)
            else:
                row["pick_ms"] = by_plan["default"]
            total[kind]["pick"] += row["pick_ms"]
            total[kind]["library"] += row["library_ms"]
            out[f"{layer}_{kind}"] = row
        del x, w
    out["total"] = total
    out["worst_ratio"] = worst
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[2]))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_conv: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label, "src": args.src, "smi": smi,
           "device": torch.cuda.get_device_name(0)}
    out.update(time_layers(gen, dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
