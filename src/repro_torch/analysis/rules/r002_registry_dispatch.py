"""R002 registry-dispatch: every aten contraction of a run originates from
a registry op.

The paper's single-engine claim is only checkable if every dense
contraction routes through `ComputeEngine`: model code calling
``torch.einsum`` / ``x @ w`` directly bypasses the backend registry, the
precision policy and the autotune cache.  The engine runs each dispatch
under ``named_scope(op_scope(op))`` ("repro.op.<op>"), which the trace
stamps on every aten call it records, and a backward op carries its
forward node's scope (`analysis/trace.py`), as JAX's transposed equations
keep their forward's name stack.  Any contraction without that marker
was emitted outside the engine.  `matmul` and `einsum` are not aten ops
of their own below autograd: they show as the `mm` / `bmm` they decompose
to.
"""
from repro_torch.analysis import lint
from repro_torch.analysis import trace as trace_lib
from repro_torch.core import backends

RULE_ID = "R002"
SEVERITY = "error"

CONTRACTIONS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "matmul", "einsum", "linear", "_scaled_mm",
    "convolution", "_convolution", "convolution_backward",
    "cudnn_convolution", "mkldnn_convolution",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_flash_attention_for_cpu_backward",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_cudnn_attention_backward",
    "_flash_attention_forward", "_flash_attention_backward",
    "_efficient_attention_forward", "_efficient_attention_backward",
})


@lint.register_rule(RULE_ID, title="registry-dispatch", severity=SEVERITY)
def check(ctx: lint.LintContext) -> list:
    """Every aten contraction carries the engine's repro.op.* scope."""
    if ctx.trace is None:
        return []
    findings = []
    for rec in ctx.trace.records:
        if rec.name not in CONTRACTIONS:
            continue
        if backends.OP_SCOPE_PREFIX in rec.scope:
            continue
        outs = [t.shape for t in rec.outputs]
        findings.append(lint.Finding(
            rule_id=RULE_ID, severity=SEVERITY,
            op_path=trace_lib.path(rec),
            message=(f"{rec.op} -> {outs} was emitted outside a registry "
                     f"op (no '{backends.OP_SCOPE_PREFIX}*' dispatch scope "
                     f"on its scope path) — route dense math through "
                     f"ComputeEngine")))
    return findings
