"""End to end: train a ~100M-param qwen2-family model for a few
hundred steps with checkpointing, restart-on-failure and straggler watchdog.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
        [--device cpu --tiny]

This exercises the full production loop (data pipeline -> microbatched
train step -> AdamW -> atomic checkpoints).  ~100M params: 12L d=512.
``--tiny`` trains the reduced qwen2-0.5b instead (a few seconds on the
CPU).  On the card it runs on `cuda`, on the CPU on `eager`.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import make_engine
from repro_torch.launch.train import train_loop
from repro_torch.models.transformer import param_counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the reduced qwen2-0.5b in place of the ~100M model")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = reduced(get_arch("qwen2-0.5b"))
    else:
        # ~100M-param member of the qwen2 family (vocab dominates).
        cfg = dataclasses.replace(
            get_arch("qwen2-0.5b"),
            name="qwen2-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=2, head_dim=64, d_ff=1536, vocab_size=65536,
        )
    total, _ = param_counts(cfg)
    print(f"[train_lm] params: {total/1e6:.1f}M")
    dev = torch.device(args.device)
    engine = make_engine("cuda" if dev.type == "cuda" else "eager",
                         device=dev)
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_dir=args.ckpt_dir, ckpt_every=100, lr=3e-4,
               num_microbatches=2, log_every=10, engine=engine)


if __name__ == "__main__":
    main()
