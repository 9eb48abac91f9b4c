"""Device time of the two attention kernels at qwen2-0.5b's serving shapes.

    python3 src/repro_torch/kernels/time_attention.py [--src DIR] [--label L]

Builds `flash_attention` and `flash_decode` from the package under `--src`
(default: this checkout's ``src``) and prints one JSON line: the median
device time in ms of each kernel over CUDA-graph replays, at a 64-token
prefill chunk (batch 1 and 4), a 512-token prompt, and one decode row
against 1024 keys at batch 1 and 8.  Pointing `--src` at the ``src`` of
another checkout times that version's kernels on the same inputs, so two
versions can be compared within one run on one card.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

# (batch, Sq, Skv, kv_len per sequence, causal) with 14 query heads over 2
# kv-heads of 64, as qwen2-0.5b dispatches them
SHAPES = {"prefill_chunk": (1, 64, 1024, [576], True),
          "prefill_chunk_b4": (4, 64, 1024, [576, 300, 900, 64], True),
          "prompt_512": (1, 512, 512, [512], True),
          "decode_b1": (1, 1, 1024, [1024], False),
          "decode_b8": (8, 1, 1024, [1024] * 8, False)}


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[2]))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    build.build_all(("flash_attention", "flash_decode"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"label": args.label, "src": args.src}
    for name, (b, sq, skv, lens, causal) in SHAPES.items():
        q = torch.randn(b, sq, 14, 64, generator=gen, device=dev) / 8
        k = torch.randn(b, skv, 2, 64, generator=gen, device=dev)
        v = torch.randn(b, skv, 2, 64, generator=gen, device=dev)
        kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
        if ops.use_decode_formulation(sq, skv):
            ns, span = ops.decode_splits(skv, k.shape[2])
            out[name] = graph_ms(lambda: fd.flash_decode_partials(
                q, k, v, kvl, causal=causal, n_splits=ns, span=span))
        else:
            out[name] = graph_ms(lambda: fa.flash_attention_fwd(
                q, k, v, kvl, causal=causal))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
