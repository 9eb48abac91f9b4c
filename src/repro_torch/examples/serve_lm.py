"""Serve a small LM through the continuous-batching paged-pool frontend.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The default LM serving path: a ragged batch of greedy-decode requests runs
through `PagedServingEngine`: chunked prefill interleaved with decode over
a shared pool of fixed-size KV blocks, dispatched through a bounded set of
shape buckets.  The fixed-slot `ServingEngine` remains as the baseline.
On the card it runs on `cuda`, on the CPU on `eager`.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import make_engine
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request
from repro_torch.serve.scheduler import PagedServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = reduced(get_arch("qwen2-0.5b"))
    engine = make_engine("cuda" if dev.type == "cuda" else "eager",
                         "fp32_strict", device=dev)
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)

    rng = np.random.default_rng(1)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(4, 24))).tolist(),
                    max_new=int(rng.integers(4, 13)))
            for i in range(8)]

    frontend = PagedServingEngine(
        cfg, params, engine=engine, kv_blocks=16, block_size=16,
        max_len=64, chunk=8, prefill_budget=32)

    t0 = time.perf_counter()
    frontend.run(reqs)
    wall = time.perf_counter() - t0

    st = frontend.stats()
    lat = st["latency_s"]
    print(f"[serve_lm] {st['requests']['completed']}/{len(reqs)} requests, "
          f"{st['tokens']} tokens in {wall:.2f}s "
          f"({st['tokens'] / wall:.1f} tok/s)")
    print(f"[serve_lm] latency p50={lat['p50'] * 1e3:.0f}ms "
          f"p95={lat['p95'] * 1e3:.0f}ms p99={lat['p99'] * 1e3:.0f}ms")
    print(f"[serve_lm] peak concurrency={st['peak_active']} "
          f"pool peak={st['pool']['peak_used']}/{st['pool']['n_blocks']} "
          f"blocks, traces={st['compile']['traces']}/{st['trace_bound']}")
    print("[serve_lm] sample generations (token ids):")
    for r in reqs[:4]:
        print(f"  req{r.rid}: prompt[{len(r.prompt)}] -> {r.out}")


if __name__ == "__main__":
    main()
