"""Trace-lint: a rule-based static analyzer for compiled networks (PyTorch
port of ``repro/analysis/lint.py``).

The JAX linter walks a compiled network's closed jaxpr, its HLO and the
engine's trace-time dispatch log.  The port's counterpart of the jaxpr is
`analysis/trace.py`'s `Trace`: every aten call of one run, forward and
backward, with its shapes, dtypes, the `repro_torch.scopes` path it ran
under and its operands' origin; the counterpart of the HLO totals is
`analysis/trace_cost.py`; the dispatch log is the registry's
(`core/backends.py`).  Rules emit structured findings ``{rule_id,
severity, op_path, message}``.

Shipped rules (`repro_torch/analysis/rules/`, docs/lint.md):

  R001 no-head-broadcast   no op materializes KV-shaped K/V at H heads
  R002 registry-dispatch   every matmul/conv/SDPA comes from a registry op
  R003 dtype-hygiene       no fp64 leaks; half -> fp32 upcasts in open code
  R004 kernel-param        the dispatched tile plans are legal
  R005 const-bloat         no large tensor captured by closure

Entry points:

  * `CompiledNetwork.lint()` / `Network.compile(..., lint="warn"|"error")`
  * `run_lint(ctx)` on a hand-built `LintContext` (rule unit tests)
  * `lint_traced(fn, *args, backend=...)`: run `fn` once under the trace
  * CLI: ``python -m repro_torch.analysis.lint --config darknet_ref
    --backend eager --device cpu`` over the shipped config zoo (``--json``
    for machine output); the backend defaults to `cuda`, on the card;
    exit status 1 when any error-severity finding survives suppression.

Suppression syntax: ``"R005"`` silences a rule, ``"R002:ssm"`` silences
findings whose op_path (or message) contains the substring after the colon.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable

import torch

from repro_torch.analysis import trace as trace_lib

SEVERITIES = ("error", "warning")

# Default byte threshold above which a captured tensor is const-bloat.
DEFAULT_CONST_THRESHOLD = 1 << 20


# --------------------------------------------------------------- findings ---

@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured lint finding."""
    rule_id: str
    severity: str      # "error" | "warning"
    op_path: str       # where: trace record path or dispatch-log key
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"{self.rule_id} [{self.severity}] {self.op_path}: "
                f"{self.message}")


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    title: str
    severity: str               # default severity (rules may mix)
    doc: str
    fn: Callable[["LintContext"], list[Finding]]


RULES: dict[str, Rule] = {}


def register_rule(rule_id: str, *, title: str, severity: str, doc: str = ""):
    """Decorator registering a rule function `(LintContext) -> [Finding]`.

    Raises ValueError on a duplicate id or an unknown severity: rule typos
    fail at import, not at lint time.
    """
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}; "
                         f"choose from {SEVERITIES}")

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"rule {rule_id!r} already registered")
        RULES[rule_id] = Rule(rule_id=rule_id, title=title,
                              severity=severity, doc=doc or fn.__doc__ or "",
                              fn=fn)
        return fn
    return deco


def unregister_rule(rule_id: str) -> None:
    """Remove a rule registration (no-op when absent; test scaffolding)."""
    RULES.pop(rule_id, None)


# ---------------------------------------------------------------- context ---

@dataclasses.dataclass(frozen=True)
class LintContext:
    """Everything the rules may inspect for one run.

    Any field may be empty/None: each rule checks only what it needs, so a
    hand-built context with just a trace unit-tests the trace rules.
    `trace` stands where JAX's context has `jaxpr`; `cost` asks `run_lint`
    for the trace's totals (the report's `hlo_totals`), where JAX's asks
    by carrying `hlo_text`.
    """
    label: str = ""
    backend: str = ""
    trace: trace_lib.Trace | None = None
    op_log: tuple = ()                   # engine dispatch records (dicts)
    head_hints: tuple = ()               # ((H, KV, head_dim), ...) for R001
    const_threshold: int = DEFAULT_CONST_THRESHOLD
    cost: bool = False

    def attention_heads(self) -> tuple:
        """(H, KV, head_dim) triples: the explicit hints plus every
        attention dispatch recorded in the op log."""
        hints = set(tuple(h) for h in self.head_hints)
        for rec in self.op_log:
            if rec.get("op") != "attention" or not rec.get("shapes"):
                continue
            q_shape, k_shape = rec["shapes"]
            hints.add((q_shape[2], k_shape[2], q_shape[3]))
        return tuple(sorted(hints))


# ----------------------------------------------------------------- report ---

class LintError(Exception):
    """Raised by `Network.compile(..., lint="error")` on error findings."""

    def __init__(self, report: "LintReport"):
        self.report = report
        super().__init__(report.format())


@dataclasses.dataclass
class LintReport:
    label: str
    backend: str
    findings: list[Finding]
    suppressed: list[Finding]
    hlo_totals: dict | None = None   # flops/bytes/collectives (trace_cost)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        """True when no error-severity finding survived suppression."""
        return not self.errors

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "backend": self.backend,
            "summary": {"errors": len(self.errors),
                        "warnings": len(self.warnings),
                        "suppressed": len(self.suppressed)},
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "hlo_totals": self.hlo_totals,
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def format(self) -> str:
        head = (f"lint[{self.label or '?'} @ {self.backend or '?'}]: "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)"
                + (f", {len(self.suppressed)} suppressed"
                   if self.suppressed else ""))
        lines = [head] + [f"  {f}" for f in self.findings]
        return "\n".join(lines)


# ------------------------------------------------------------ suppression ---

def _parse_suppression(token: str) -> tuple[str, str | None]:
    """'R005' -> (R005, None); 'R002:ssm' -> (R002, 'ssm')."""
    rule_id, _, pattern = token.partition(":")
    rule_id = rule_id.strip()
    if not rule_id:
        raise ValueError(f"empty rule id in suppression {token!r}")
    return rule_id, (pattern or None)


def _is_suppressed(f: Finding, parsed: list[tuple[str, str | None]]) -> bool:
    for rule_id, pattern in parsed:
        if f.rule_id != rule_id:
            continue
        if pattern is None or pattern in f.op_path or pattern in f.message:
            return True
    return False


# ----------------------------------------------------------------- runner ---

def run_lint(ctx: LintContext, *, suppress=(), rules=None) -> LintReport:
    """Run the registered rules over one context.

    Args:
      ctx: the `LintContext` under test.
      suppress: iterable of suppression tokens (see module docstring).
      rules: optional iterable of rule ids to restrict the run to.

    Returns a `LintReport` (errors first, then warnings, by rule id), its
    `hlo_totals` the trace's cost totals when ``ctx.cost``.  Raises
    ValueError on a malformed suppression token or an unknown rule id in
    `rules`.
    """
    from repro_torch.analysis import rules as _rules_pkg  # noqa: F401
    parsed = [_parse_suppression(t) for t in suppress]
    if rules is not None:
        unknown = set(rules) - set(RULES)
        if unknown:
            raise ValueError(f"unknown rule ids {sorted(unknown)}; "
                             f"registered: {sorted(RULES)}")
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for rule_id in sorted(RULES):
        if rules is not None and rule_id not in rules:
            continue
        for f in RULES[rule_id].fn(ctx):
            (suppressed if _is_suppressed(f, parsed) else findings).append(f)
    findings.sort(key=lambda f: (SEVERITIES.index(f.severity), f.rule_id))
    hlo_totals = None
    if ctx.cost and ctx.trace is not None:
        # every lint run with totals exercises diagnose.attribute on a
        # real trace, as JAX's does on real compiled HLO
        from repro_torch.analysis import diagnose
        hlo_totals = diagnose.attribute(ctx.trace, top=5,
                                        log=ctx.op_log)["totals"]
    return LintReport(label=ctx.label, backend=ctx.backend,
                      findings=findings, suppressed=suppressed,
                      hlo_totals=hlo_totals)


# ------------------------------------------------------------ entry points ---

def _threshold(const_threshold: int | None) -> int:
    return (DEFAULT_CONST_THRESHOLD if const_threshold is None
            else const_threshold)


def lint_traced(fn, *args, backend: str, label: str = "", head_hints=(),
                suppress=(), const_threshold: int | None = None,
                compile_hlo: bool = True) -> LintReport:
    """Run ``fn(*args)`` once under the trace (`trace.record`), then lint
    the trace and the dispatch log it left.

    `args` are tensors or trees of them (dicts, lists, tuples, modules):
    they are the roots R005 measures against.  `compile_hlo=False` leaves
    the report's `hlo_totals` None (JAX's flag skips the XLA compile; the
    port has none, and skips only the trace's cost)."""
    from repro_torch.core import backends
    mark = backends.dispatch_log_size()
    trace, _ = trace_lib.trace_call(fn, *args)
    op_log = tuple(backends.dispatch_log()[mark:])
    ctx = LintContext(
        label=label, backend=backend, trace=trace, op_log=op_log,
        head_hints=tuple(head_hints),
        const_threshold=_threshold(const_threshold), cost=compile_hlo)
    return run_lint(ctx, suppress=suppress)


def lint_compiled_network(cn, *, suppress=(),
                          const_threshold: int | None = None) -> LintReport:
    """Lint a `CompiledNetwork` from its build's capture (the trace and the
    dispatch log): nothing runs again."""
    ctx = LintContext(
        label=f"CompiledNetwork(batch={cn.batch_size})",
        backend=cn.net.engine.backend, trace=cn.trace,
        op_log=tuple(cn.op_log),
        const_threshold=_threshold(const_threshold), cost=True)
    return run_lint(ctx, suppress=suppress)


# ----------------------------------------------------------- config zoo ---

_CNN_CONFIGS = ("darknet_ref", "darknet19", "segnet_small")


def _cnn_cfg_text(name: str) -> str:
    from repro_torch.configs import darknet_ref as dk
    return {"darknet_ref": dk.DARKNET_SMALL_CFG,
            "darknet19": dk.DARKNET19_CFG,
            "segnet_small": dk.SEGNET_SMALL_CFG}[name]


def _resolve_lm_arch(name: str) -> str:
    """Accept both module-style ('qwen2_0p5b') and arch-id ('qwen2-0.5b')
    spellings.  Raises ValueError with the full zoo when unknown."""
    from repro_torch.configs import base
    if name in base._MODULES:
        return name
    by_module = {mod: arch for arch, mod in base._MODULES.items()}
    if name in by_module:
        return by_module[name]
    raise ValueError(
        f"unknown config {name!r}; CNN configs: {list(_CNN_CONFIGS)}, "
        f"LM configs: {sorted(base._MODULES)} "
        f"(module names {sorted(by_module)} also accepted)")


def lint_config(name: str, *, backend: str = "cuda", batch: int = 2,
                seq: int = 16, suppress=(),
                const_threshold: int | None = None,
                device: str | torch.device = "cuda") -> LintReport:
    """Build one shipped config on `backend` and lint it.

    CNN configs (darknet_ref/darknet19/segnet_small) go through
    `Network.compile` (the build's trace); LM configs trace the reduced
    architecture's prefill step (forward step for encoder-only archs) at
    (batch, seq), its parameters and inputs from seed 0.  The engine is
    `make_engine(backend, device=device)`: the card by default.

    Returns the `LintReport`.  Raises ValueError for an unknown config or
    backend, RuntimeError for the card when there is none.
    """
    from repro_torch.core import make_engine
    if name not in _CNN_CONFIGS:
        arch_id = _resolve_lm_arch(name)
    eng = make_engine(backend, device=device)
    if name in _CNN_CONFIGS:
        from repro_torch.core.darknet.network import Network
        net = Network(_cnn_cfg_text(name), eng)
        cn = net.compile(batch_size=batch)
        report = lint_compiled_network(cn, suppress=suppress,
                                       const_threshold=const_threshold)
        report.label = name
        return report

    from repro_torch.configs import base
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import serve_step
    cfg = base.reduced(base.get_arch(arch_id))
    gen = torch.Generator(device=eng.device).manual_seed(0)
    params = tfm.init_params(cfg, generator=gen, device=eng.device)
    shape = base.ShapeConfig("lint", seq, batch, "prefill")
    inputs = base.input_tensors(cfg, shape, generator=gen,
                                device=eng.device)
    if cfg.causal:
        step = serve_step.make_prefill_step(eng, cfg)
    else:
        step = serve_step.make_forward_step(eng, cfg)
    with torch.inference_mode():
        return lint_traced(
            step, params, inputs, backend=backend, label=name,
            head_hints=((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),),
            suppress=suppress, const_threshold=const_threshold)


# -------------------------------------------------------------------- CLI ---

def _format_rules() -> str:
    from repro_torch.analysis import rules as _rules_pkg  # noqa: F401
    lines = ["registered rules:"]
    for rule_id in sorted(RULES):
        r = RULES[rule_id]
        lines.append(f"  {r.rule_id} [{r.severity:7s}] {r.title}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Trace-lint a shipped config's network (docs/lint.md).")
    ap.add_argument("--config", help="config name: darknet_ref | darknet19 "
                    "| segnet_small | an LM arch (qwen2_0p5b / qwen2-0.5b)")
    ap.add_argument("--backend", default="cuda",
                    help="registry backend to run on (default: cuda)")
    ap.add_argument("--device", default="cuda",
                    help="device of the engine (default: cuda; 'cpu' with "
                    "--backend eager or ref)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16,
                    help="sequence length for LM configs")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="RULE[:SUBSTR]",
                    help="suppress a rule (repeatable), e.g. R005 or "
                    "R002:ssm")
    ap.add_argument("--const-threshold", type=int,
                    default=DEFAULT_CONST_THRESHOLD,
                    help="R005 byte threshold for captured tensors")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_format_rules())
        return 0
    if not args.config:
        ap.error("--config is required (or --list-rules)")

    report = lint_config(args.config, backend=args.backend,
                         batch=args.batch, seq=args.seq,
                         suppress=args.suppress,
                         const_threshold=args.const_threshold,
                         device=args.device)
    print(report.to_json() if args.json else report.format())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
