"""Quickstart: the paper's compute engine in 30 lines.

1. Run a fused FP32 GEMM on the engine (two backends of the registry).
2. Build a Darknet CNN from a cfg string, compile once, run inference.
3. Evaluate one LM training loss on a reduced architecture.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the GEMM runs on `eager` (PyTorch) and on `cuda` (the
hand-written kernel); on the CPU on `eager` and `ref` (the plain oracle).
"""
import argparse
import math

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.core import list_backends, make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.models import transformer as tfm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    kernel = "cuda" if dev.type == "cuda" else "ref"

    # --- 1. the engine: fused act((x@w)*scale+shift), fp32 strict --------
    # Backends resolve through the op registry; add your own with
    # repro_torch.core.register_backend.
    print(f"registered backends: {list_backends()}")
    engine_eager = make_engine("eager", "fp32_strict", device=dev)
    engine_kernel = make_engine(kernel, "fp32_strict", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((200, 300), generator=gen, device=dev)
    w = torch.randn((300, 100), generator=gen, device=dev)
    bias = torch.ones((100,), device=dev)
    y1 = engine_eager.matmul(x, w, shift=bias, act="leaky")
    y2 = engine_kernel.matmul(x, w, shift=bias, act="leaky")
    print(f"engine backends agree: {float((y1 - y2).abs().max()):.2e}")

    # --- 2. the paper's use-case: Darknet CNN, compiled once --------------
    net = Network(DARKNET_SMALL_CFG, engine_kernel)
    img = torch.randn((4, 28, 28, 3), generator=gen, device=dev)
    compiled = net.compile(batch_size=4)           # ONE build
    probs = compiled(img)
    print(f"darknet CNN: input {tuple(img.shape)} -> class probs "
          f"{tuple(probs.shape)}, sum={float(probs.sum(-1)[0]):.4f}, "
          f"engine plan={compiled.op_counts}")

    # --- 3. the substrate: one LM train loss (reduced qwen2) --------------
    cfg = reduced(get_arch("qwen2-0.5b"))
    lm_params = tfm.init_params(cfg, generator=gen, device=dev)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                                device=dev),
        "labels": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                                device=dev),
    }
    with torch.no_grad():
        loss = tfm.loss_fn(engine_kernel, cfg, lm_params, batch,
                           ce_chunk=32, n_q_chunks=4)
    print(f"LM train loss (random init, V={cfg.vocab_size}): "
          f"{float(loss):.3f} (ln V = {math.log(cfg.vocab_size):.3f})")


if __name__ == "__main__":
    main()
