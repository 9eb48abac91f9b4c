"""The paper's own scenario: take a Darknet cfg, compile it once on the
engine, run batched image inference, including a deconvolutional network.

    PYTHONPATH=src python -m repro_torch.examples.cnn_inference \\
        [--device cpu]

On the card the networks run on the `cuda` backend (the hand-written
GEMM), on the CPU on `eager`.
"""
import argparse

import torch

from repro_torch.configs.darknet_ref import (DARKNET19_CFG, DARKNET_SMALL_CFG,
                                             SEGNET_SMALL_CFG)
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import Network


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    engine = make_engine("cuda" if dev.type == "cuda" else "eager",
                         "fp32_strict", device=dev)

    for name, cfg_text, shape in [
        ("darknet-small (classifier)", DARKNET_SMALL_CFG, (8, 28, 28, 3)),
        ("segnet-small (deconv)", SEGNET_SMALL_CFG, (8, 32, 32, 3)),
        ("darknet19 (imagenet trunk)", DARKNET19_CFG, (1, 224, 224, 3)),
    ]:
        net = Network(cfg_text, engine)
        n_params = net.num_params()
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(shape, generator=gen, device=dev)
        # Plan once, build once, serve many: one build here, then every
        # call is the planned layer list on the engine.
        compiled = net.compile(batch_size=shape[0]).warmup()
        y = compiled(x)
        prof = compiled.profile(x, reps=3)
        op_plan = " ".join(f"{op}x{n}" for (_, op), n in
                           sorted(prof["op_counts"].items()))
        print(f"[cnn] {name}: params={n_params/1e6:.2f}M "
              f"in={tuple(shape)} out={tuple(y.shape)} "
              f"{prof['per_call_s']*1000:.1f} ms/batch "
              f"traces={prof['trace_count']} plan=[{op_plan}]")


if __name__ == "__main__":
    main()
