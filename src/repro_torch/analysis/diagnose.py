"""Per-cell bottleneck attribution (PyTorch port of
``repro/analysis/diagnose.py``): run one cell's step on the ``meta``
device under the trace (`analysis/trace.py`) and break its bytes and
collectives down by op and scope.

    PYTHONPATH=src python -m repro_torch.analysis.diagnose --arch X --shape Y

JAX attributes compiled HLO ops (with their source metadata and while-trip
multipliers); the port attributes trace records.  A row is ``(bytes, op,
count, scope)``: the records of one op under one scope path summed, a
registry op counted at its boundary (`analysis/trace_cost.py`), so
``count`` stands where JAX's rows carry a loop's trip count; a record
that ran outside every scope is labelled by its op, as JAX falls back to
the HLO op's name where there is no metadata.  The
collectives come from the dispatch log through ``kernels.sharded.predict``
(`kernels.sharded.route` per dispatch).
"""
from __future__ import annotations

import argparse
import collections

from repro_torch.analysis import trace_cost
from repro_torch.kernels import sharded


def _rows(pairs, top: int) -> list:
    """Sum (bytes, key) pairs by key into (bytes, kind, count, label)
    rows, the largest first."""
    acc: dict = {}
    for nbytes, (kind, label) in pairs:
        b, n = acc.get((kind, label), (0, 0))
        acc[(kind, label)] = (b + nbytes, n + 1)
    rows = [(float(b), kind, n, label) for (kind, label), (b, n)
            in acc.items()]
    rows.sort(key=lambda r: (-r[0], r[1], r[3]))
    return rows[:top]


def _collectives(log, sizes, strategy):
    """(dispatch index, record, collective, itemsize) for every collective
    the dispatches of `log` make on a mesh of `sizes` (none without
    one), as `kernels.sharded.predict` counts them: a dispatch a
    recompute's early stop cut short runs its backward's gathers only."""
    if not sizes:
        return
    for i, rec in enumerate(log):
        shapes = rec["shapes"]
        if rec["op"] == "bmm":
            shapes = (rec.get("batch", 1), *shapes)
        itemsize = sharded._itemsize(rec.get("dtype"))
        r = sharded.route(rec["op"], shapes, sizes, strategy,
                          itemsize=itemsize, grad=rec.get("grad", ()))
        for c in (*(() if rec.get("cut") else r.forward), *r.backward):
            yield i, rec, c, itemsize


def attribute(trace, top: int = 20, *, log=(), sizes: dict | None = None,
              strategy: str = "tp") -> dict:
    """Returns {'collectives': [(bytes, kind, count, op/dim)],
                'traffic':     [(bytes, op, count, scope)],
                'totals':      trace_cost.analyze(...)}."""
    traffic = [(b, (r.op, r.scope or r.op)) for b, r in
               trace_cost.record_bytes(trace)]
    coll = [(c.out_bytes, (c.kind, f"{rec['op']}/{c.dim}"))
            for _, rec, c, _ in _collectives(log, sizes, strategy)]
    return {"collectives": _rows(coll, top),
            "traffic": _rows(traffic, top),
            "totals": trace_cost.analyze(trace, log, sizes, strategy)}


def count_collectives(log, sizes: dict, strategy: str = "tp") -> dict:
    """Collectives by kind that the dispatches of `log` make on a mesh of
    `sizes`: ``{"all_gather": 2, "sum": 1}`` (kinds with zero count are
    omitted), the occurrence-count twin of `attribute`'s bytes."""
    return dict(collections.Counter(
        c.kind for _, _, c, _ in _collectives(log, sizes, strategy)))


def full_kv_gathers(log, sizes: dict, kv_elems: int,
                    strategy: str = "tp") -> list[str]:
    """All-gathers whose result holds >= `kv_elems` elements, i.e. at
    least one full K or V tensor (B * Skv * KV_heads * head_dim).  The
    sharded attention path must never produce one: batch / head splits
    gather only their outputs, and the sequence split only its (o, lse)
    partials, which are Sq-sized.  Returns descriptions of offenders
    (empty list == clean)."""
    bad = []
    for i, rec, c, itemsize in _collectives(log, sizes, strategy):
        elems = c.out_bytes // itemsize
        if c.kind == "all_gather" and elems >= kv_elems:
            bad.append(f"dispatch {i} {rec['op']}: all-gather of {elems} "
                       f"elements >= full-KV size {kv_elems}")
    return bad


def print_report(trace, top: int = 15, *, log=(), sizes=None,
                 strategy: str = "tp"):
    rep = attribute(trace, top, log=log, sizes=sizes, strategy=strategy)
    t = rep["totals"]
    print(f"flops={t['flops']:.3e}  bytes={t['bytes']:.3e}  "
          f"coll={t['collectives']['total']:.3e}")
    print("\n-- top collectives (bytes x count) --")
    for size, kind, n, label in rep["collectives"]:
        print(f"{size:12.3e} {kind:20s} x{n:<5d} {label[:100]}")
    print("\n-- top memory traffic --")
    for size, kind, n, label in rep["traffic"]:
        print(f"{size:12.3e} {kind:20s} x{n:<5d} {label[:100]}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.diagnose")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--policy", default="fp32_strict")
    ap.add_argument("--strategy", default="tp")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh (default 16 x 16)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    # local import: the dry run pulls in every model
    from repro_torch.analysis import trace as trace_lib
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.core import backends
    from repro_torch.launch import dryrun

    cfg, shape = get_arch(args.arch), SHAPES[args.shape]
    rec = dryrun.lower_cell(cfg, shape, policy_name=args.policy,
                            num_microbatches=args.microbatches,
                            multi_pod=args.multi_pod,
                            strategy=args.strategy)
    print(f"cell: {args.arch} x {args.shape} (policy={args.policy}, "
          f"strategy={args.strategy}, mesh={rec.get('mesh')})")
    r = rec.get("roofline", {})
    if r:
        print(f"t_comp={r['t_compute_s']:.3f} t_mem={r['t_memory_s']:.3f} "
              f"t_coll={r['t_collective_s']:.3f} dom={r['dominant']} "
              f"useful={r['useful_ratio']:.2f}")
    run, roots = dryrun.cell_step(cfg, shape, args.policy,
                                  args.microbatches)
    mark = backends.dispatch_log_size()
    with trace_lib.record(*roots) as trace:
        run()
    log = backends.dispatch_log()[mark:]
    _, sizes = dryrun._mesh_of(args.multi_pod, None)
    print_report(trace, args.top, log=log, sizes=sizes,
                 strategy=args.strategy)


if __name__ == "__main__":
    main()
