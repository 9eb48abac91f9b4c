"""End-to-end LM trainer: checkpoint/restart, failure injection, watchdog
(PyTorch port of ``repro/launch/train.py``).

Usage, on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --batch 8 --seq 512 --steps 3

The loop is deliberately boring.  Everything stateful is (params,
opt_state, data step); all three restore exactly from the latest
checkpoint, and the data pipeline is a pure function of the step index, so
a crash at step N and a restart replays step N bit for bit.  The engine
defaults to `make_engine()`, the `cuda` backend on the card, and raises
without a GPU; pass ``engine=make_engine("eager", device="cpu")`` to train
on the CPU.  Parameters are made by `init_params` from a
``torch.Generator`` seeded with `seed`, on the engine's device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import make_engine
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.fault import FailureInjector, StepWatchdog
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
               ckpt_every: int = 50, lr: float = 3e-4,
               num_microbatches: int = 1, seed: int = 0,
               fail_at_step: int | None = None, log_every: int = 10,
               engine=None, metrics_out: list | None = None):
    """Train `cfg` for `steps` AdamW steps on `SyntheticLM` batches of
    (batch, seq), resuming from the newest checkpoint in `ckpt_dir` (none
    when empty) and saving every `ckpt_every` steps, when the watchdog
    asks, and at the end.  Appends ``{"step", "loss"}`` to `metrics_out`.
    Returns ``(params, opt_state)``; raises ``FailureInjected`` at
    `fail_at_step`."""
    engine = engine or make_engine()
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                           decay_steps=steps)
    data = SyntheticLM(cfg, ShapeConfig("train", seq, batch, "train"),
                       seed=seed)
    step_fn = make_train_step(engine, cfg, ocfg,
                              num_microbatches=num_microbatches,
                              ce_chunk=min(512, seq))

    # ---- init or restore ----
    start = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, device=engine.device)
    opt_state = opt.adamw_init(flatten(params))
    if start is not None:
        (params, opt_state), _ = ckpt.restore(ckpt_dir, start,
                                              (params, opt_state))
        print(f"[train] restored step {start} from {ckpt_dir}")
    else:
        start = 0

    injector = FailureInjector(fail_at_step)
    watchdog = StepWatchdog()
    for step in range(start, steps):
        injector.check(step)
        batch_dev = {k: torch.from_numpy(v).to(engine.device)
                     for k, v in data.batch(step).items()}
        watchdog.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
        loss = float(metrics["loss"])  # waits for the step
        wd = watchdog.stop(step)
        if metrics_out is not None:
            metrics_out.append({"step": step, "loss": loss})
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"t={wd['step_time_s']:.2f}s"
                  + (" STRAGGLER" if wd["straggler"] else ""))
        if ckpt_dir and ((step + 1) % ckpt_every == 0
                         or wd["checkpoint_now"] or step == steps - 1):
            ckpt.save(ckpt_dir, step + 1, (params, opt_state),
                      extra={"loss": loss, "arch": cfg.name})
            ckpt.retain(ckpt_dir, keep=3)
    return params, opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at-step", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               lr=args.lr, num_microbatches=args.microbatches,
               fail_at_step=args.fail_at_step)


if __name__ == "__main__":
    main()
