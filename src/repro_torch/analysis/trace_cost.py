"""FLOPs, bytes and collectives of a recorded trace (the PyTorch port's
counterpart of ``repro/analysis/hlo_cost.py``).

JAX walks compiled HLO text; the port has no compiler to ask, so it counts
what `analysis/trace.py` recorded while the run went:

  * flops: each aten record's, by ``torch.utils.flop_counter``'s formulas
    (matrix products, convolutions, attention; elementwise work not), so
    the total equals ``FlopCounterMode``'s on the same run.  A `cuda`
    kernel launches through ctypes, not aten, and its FLOPs do not show.
  * bytes: operands plus results of every aten record, each read or
    written once (views and allocations are free, as ``hlo_cost``'s
    bitcasts and parameters), except that a registry op (an engine dispatch) is
    counted once at its boundary (the operands it took and the results it
    gave), as ``hlo_cost`` counts a fusion at its call site: its interior
    records are not counted.  So `eager` and `cuda` give a registry op the
    same bytes.
  * collectives: what ``kernels.sharded.predict`` gives the dispatch log
    on a mesh of `sizes`: the counts by kind, ``link_bytes`` and
    ``total`` (the bytes through a rank's links, JAX's unit).
"""
from __future__ import annotations

from repro_torch.analysis import trace as trace_lib
from repro_torch.kernels import sharded


def record_bytes(trace) -> list:
    """(bytes, record) for every counted piece of `trace`: the aten
    records outside every registry boundary, and the boundaries."""
    inside = set(trace.boundaries)
    free = trace_lib.VIEW_OPS | trace_lib.ALLOC_OPS
    rows = [(r.nbytes, r) for r in trace.records
            if r.region not in inside and r.name not in free]
    rows += [(b.nbytes, b) for b in trace.boundaries.values()]
    return rows


def collectives(log=(), sizes: dict | None = None, strategy: str = "tp",
                **kwargs) -> dict:
    """The collectives `kernels.sharded.predict` reads off `log` on a
    mesh of `sizes` (none without a mesh): counts by kind plus
    ``link_bytes`` and ``total``, both the link bytes."""
    if not sizes or all(n == 1 for n in sizes.values()):
        return {"total": 0}
    pred = sharded.predict(log, sizes, strategy, **kwargs)
    return {**pred["collectives"], "link_bytes": pred["link_bytes"],
            "total": pred["link_bytes"]}


def analyze(trace, log=(), sizes: dict | None = None,
            strategy: str = "tp", **kwargs) -> dict:
    """``{"flops", "bytes", "collectives": {..., "total"}}`` of one
    recorded run (see the module docstring); `log` is the dispatch log of
    the same run (`core.backends.dispatch_log`), `kwargs` go to
    `sharded.predict` (``staged``, ``extra``)."""
    return {"flops": float(trace.flops()),
            "bytes": float(sum(b for b, _ in record_bytes(trace))),
            "collectives": collectives(log, sizes, strategy, **kwargs)}
