"""R003 dtype-hygiene: no fp64 leaks; stray upcasts in open code.

Two sub-checks:

  * fp64 leak (error): any aten call producing float64/complex128.  The
    precision policies are fp32-accumulate; a double anywhere means a
    numpy scalar or a float64 default leaked in and doubled the memory
    traffic of everything downstream.
  * stray upcast (warning): a half-precision -> fp32 ``_to_copy`` OUTSIDE
    a registry op's "repro.op." scope.  Declared accumulators (the
    engine's fp32-accumulate epilogues, statistics inside dispatch scopes)
    are expected; an upcast in open model code usually means a bf16
    activation silently promoted.  fp32_strict networks have no half
    tensors, so this fires only under `mixed`.

JAX's third sub-check, a weakly-typed entry, has no counterpart by
design: PyTorch tensors carry no weak type (a Python scalar never widens
a tensor's dtype and never retraces anything).  The implicit promotions
JAX spells as ``convert_element_type`` (``bf16 * f32``) are inside the
PyTorch op here and show no ``_to_copy``.
"""
from repro_torch.analysis import lint
from repro_torch.analysis import trace as trace_lib
from repro_torch.core import backends

RULE_ID = "R003"
SEVERITY = "error"   # the fp64 leak; the upcast sub-check emits warnings

_WIDE = ("float64", "complex128")
_HALF = ("bfloat16", "float16")


@lint.register_rule(RULE_ID, title="dtype-hygiene", severity=SEVERITY)
def check(ctx: lint.LintContext) -> list:
    """No fp64; flag half -> fp32 upcasts outside dispatch."""
    if ctx.trace is None:
        return []
    findings = []
    for rec in ctx.trace.records:
        for t in rec.outputs:
            if t.dtype in _WIDE:
                findings.append(lint.Finding(
                    rule_id=RULE_ID, severity="error",
                    op_path=trace_lib.path(rec),
                    message=(f"{rec.op} produces {t.dtype} {t.shape} — "
                             f"fp64 leaked into an fp32-accumulate "
                             f"network")))
                break
        if (rec.name == "_to_copy"
                and backends.OP_SCOPE_PREFIX not in rec.scope
                and rec.inputs and rec.outputs
                and rec.inputs[0].dtype in _HALF
                and rec.outputs[0].dtype == "float32"):
            findings.append(lint.Finding(
                rule_id=RULE_ID, severity="warning",
                op_path=trace_lib.path(rec),
                message=(f"{rec.inputs[0].dtype} -> float32 upcast outside "
                         f"any '{backends.OP_SCOPE_PREFIX}*' dispatch scope "
                         f"— not a declared accumulator; downstream ops now "
                         f"run fp32")))
    return findings
