"""R004 kernel-param legality: every tile plan a run dispatched is legal
for its problem.

The static pre-launch check the paper's toolflow lineage runs before
committing a design to hardware: each record of the engine's dispatch log
carries the RESOLVED plan (heuristic pick, measured winner or persisted
table entry), and `backends.validate_tiles` re-derives the kernels'
legality from the same tables the launchers use: the plan is
instantiated (`gemm.PLANS`, `gemm.BWD_PLANS`, `flash_attention.PLANS`),
fits its head dim and shared memory, and the decode's split is
`decode_splits`'.  A corrupt persisted autotune table cannot reach a
launch with an illegal plan unnoticed.
"""
from repro_torch.analysis import lint
from repro_torch.core import backends

RULE_ID = "R004"
SEVERITY = "error"


@lint.register_rule(RULE_ID, title="kernel-param-legality", severity=SEVERITY)
def check(ctx: lint.LintContext) -> list:
    """Dispatched tile plans are instantiated and fit their problem."""
    findings = []
    seen = set()
    for rec in ctx.op_log:
        tiles = tuple(rec.get("tiles") or ())
        if not tiles or rec.get("shapes") is None:
            continue   # untiled backend (eager/ref) or a legacy record
        key = (rec["op"], repr(rec["shapes"]), rec.get("dtype"), tiles)
        if key in seen:
            continue
        seen.add(key)
        problems = backends.validate_tiles(rec["op"], rec["shapes"],
                                           rec.get("dtype") or "float32",
                                           tiles)
        for problem in problems:
            findings.append(lint.Finding(
                rule_id=RULE_ID, severity=SEVERITY,
                op_path=f"{rec.get('backend', '?')}:{rec['op']}"
                        f"{tuple(rec['shapes'])}",
                message=f"tile plan {tiles} is illegal: {problem}"))
    return findings

