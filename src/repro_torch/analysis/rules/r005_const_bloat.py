"""R005 const-bloat: no large tensor captured by closure.

In JAX a concrete array captured by closure (instead of passed as an
argument) becomes a jaxpr constant, serialized into every lowering.  The
eager counterpart is a tensor an op reads that is neither reachable from
the traced call's arguments (its argument trees, the parameters and
buffers of a module among them, views of their storage) nor made by an
earlier op of the trace (`analysis/trace.py`'s ``("const", k)`` source): a
table held on a Python object, a host array wrapped with ``from_numpy``.
Weights must flow through the parameters; lookup tables above the
threshold (`LintContext.const_threshold`, default 1 MiB) should be
arguments or computed in the run.
"""
from repro_torch.analysis import lint
from repro_torch.analysis import trace as trace_lib

RULE_ID = "R005"
SEVERITY = "warning"


@lint.register_rule(RULE_ID, title="const-bloat", severity=SEVERITY)
def check(ctx: lint.LintContext) -> list:
    """No captured tensor exceeds the byte threshold."""
    if ctx.trace is None:
        return []
    findings = []
    seen = set()
    for rec in ctx.trace.records:
        for t in rec.inputs:
            if (t.source is None or t.source[0] != "const"
                    or t.nbytes <= ctx.const_threshold
                    or t.source in seen):
                continue
            seen.add(t.source)
            findings.append(lint.Finding(
                rule_id=RULE_ID, severity=SEVERITY,
                op_path=trace_lib.path(rec),
                message=(f"tensor {t.dtype}{t.shape} ({t.nbytes} bytes) "
                         f"captured by the traced call (threshold "
                         f"{ctx.const_threshold}) — pass it as an argument "
                         f"so the caller owns its memory")))
    return findings
