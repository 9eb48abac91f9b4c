"""Serve a compiled Darknet CNN behind the unified serving frontend.

    PYTHONPATH=src python -m repro_torch.examples.serve_cnn [--device cpu]

The paper's deployment shape end to end: build the network once per batch
bucket (`Network.compile_cache`), stand up the micro-batching
`CNNServingEngine`, and push a ragged request stream through it: padded
bucket dispatch, per-request latency, aggregate images/sec.

Doubles as the serving smoke: exits non-zero if any bucket rebuilds
(builds must equal the number of built buckets) or if traffic does not
complete.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.serve.frontend import CNNServingEngine, ImageRequest

BUCKETS = (1, 2, 4, 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    net = Network(DARKNET_SMALL_CFG, make_engine(
        "cuda" if dev.type == "cuda" else "eager", "fp32_strict",
        device=dev))
    cache = net.compile_cache(buckets=BUCKETS)
    engine = CNNServingEngine(cache)

    # ragged arrival pattern: bursts of 1..9 images
    rng = np.random.default_rng(0)
    h, w, c = net.in_shape
    rid = 0
    for burst in (1, 3, 8, 2, 9, 4, 1, 5):
        reqs = []
        for _ in range(burst):
            reqs.append(ImageRequest(
                rid=rid,
                image=rng.standard_normal((h, w, c)).astype(np.float32)))
            rid += 1
        engine.run(reqs)
        assert all(r.done and r.result is not None for r in reqs)

    st = engine.stats()
    cs = st["cache"]
    print(f"[serve_cnn] served {st['requests']['completed']} requests in "
          f"{st['steps']} micro-batches: {st['throughput']:.1f} img/s, "
          f"avg latency {st['latency_s']['avg'] * 1e3:.1f} ms")
    print(f"[serve_cnn] buckets={cs['buckets']} compiled={cs['compiled']} "
          f"traces={cs['traces']} dispatches={cs['dispatches']}")
    print(f"[serve_cnn] pad waste {cs['pad_waste'] * 100:.1f}% "
          f"({cs['rows_padded']} padded / "
          f"{cs['rows_real'] + cs['rows_padded']} dispatched rows)")

    # rebuild-count regression guard (smoke): `misses` counts every build
    # the cache ever performed, so one build per bucket means misses ==
    # built buckets.
    if cs["misses"] != len(cs["compiled"]) or cs["traces"] != len(
            cs["compiled"]):
        raise SystemExit(f"retrace regression: {cs['misses']} compiles / "
                         f"{cs['traces']} traces for "
                         f"{len(cs['compiled'])} compiled buckets")
    if st["requests"]["completed"] != rid:
        raise SystemExit(f"dropped traffic: {st['requests']['completed']} "
                         f"of {rid} requests completed")
    print("[serve_cnn] OK: one trace per bucket, all traffic served")


if __name__ == "__main__":
    main()
