"""The control of the check that decides ``correct``: the plain reference
put in the program's place and computed in TF32, the nearest precision
below the configurations' fp32, against the fp32 reference.

    python3 bench/tools/control.py --config darknet19 --seeds 1 2 3

For each seed: the weights and the whole image pool at the cell's size,
as a run makes them, through the reference twice (TF32 off, then on).
Prints one JSON line a seed with ``max_log_prob_gap`` (the number a run
compares), which has to come out above the configuration's limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pool", type=int, default=256)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench")]
    import torch
    from harness import check, spec, traffic, weights
    from reference import cfg, darknet
    if not torch.cuda.is_available():
        raise SystemExit("control: no CUDA device")
    dev = torch.device("cuda", 0)
    conf = spec.load_config(args.config)
    table = cfg.layers(conf["cfg_text"])
    limit = conf["limits"]["max_log_prob_gap"]
    for seed in args.seeds:
        raw = weights.make(table, conf["weights"], seed, dev)
        images = torch.from_numpy(traffic.pool(
            seed, args.pool, table[0].in_shape, dev)).to(dev)
        outs = {}
        for tf32 in (False, True):
            with darknet.precision(tf32=tf32), torch.no_grad():
                outs[tf32] = darknet.forward_blocks(
                    table, raw, images, conf["reference_block"]).cpu().numpy()
        gap = float(check.log_gap(outs[True], outs[False]).max())
        print(json.dumps({"config": args.config, "seed": seed,
                          "control": "reference in TF32",
                          "max_log_prob_gap": gap, "limit": limit,
                          "fails_the_check": gap > limit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
