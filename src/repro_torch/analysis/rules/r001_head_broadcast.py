"""R001 no-head-broadcast: no op materializes KV-shaped K/V at H query
heads.

The grouped-KV layout contract says the compact (B, S, KV, hd) K/V operand
reaches the attention op unexpanded (query head h attends kv-head
h // (H/KV) inside the kernel), so a reintroduced ``k.repeat_interleave(G,
dim=2)`` must never appear in a run, forward or backward, in either the
engine (B, S, heads, hd) or the kernel (B, heads, S, hd) axis order.

The shape tests are JAX's (`_is_suspect`, `_is_expanded`, `_expands`).  In
JAX the broadcast_in_dim itself is the finding.  In PyTorch ``expand`` is
a view that copies nothing, so the finding is the first MATERIALIZING op
of the expansion: a ``clone`` / ``repeat`` / ``index_select`` / ``cat`` /
copying ``reshape`` that reads an expanded view of a KV operand (an
``expand`` that does one step of the KV -> H expansion, through any chain
of views), or that does such a step itself (``repeat``, ``index_select``
or ``cat`` straight from KV to H heads).

Head geometry (H, KV, head_dim) comes from the context's attention
dispatch records (and/or explicit `head_hints`); networks without grouped
attention (G < 2, or no attention at all) produce no findings.
"""
from repro_torch.analysis import lint
from repro_torch.analysis import trace as trace_lib

RULE_ID = "R001"
SEVERITY = "error"

# ops that write an expanded view out (a copying reshape and
# ``contiguous`` show as clone, a dtype change as _to_copy)
MATERIALIZING = frozenset({
    "clone", "repeat", "repeat_interleave", "index_select", "cat",
    "_to_copy", "copy", "copy_"})


def _is_suspect(s: tuple, kv: int, hd: int) -> bool:
    """Shapes a compact KV operand takes: (…, KV, …, hd) in the engine
    order (B, S, KV, hd), the kernel order (B, KV, S, hd), or a
    G-insertion staging form with a singleton group axis right of KV."""
    if not s or s[-1] != hd:
        return False
    if len(s) == 4:
        return s[1] == kv or s[2] == kv
    if len(s) == 5:
        return (s[2] == kv and s[3] == 1) or (s[1] == kv and s[2] == 1)
    return False


def _is_expanded(s: tuple, h: int, kv: int, g: int, hd: int) -> bool:
    """Shapes an H-expanded operand takes: H on the head axis of either
    order, or the (…, KV, G, …, hd) broadcast intermediate."""
    if not s or s[-1] != hd:
        return False
    if len(s) == 4:
        return s[1] == h or s[2] == h
    if len(s) == 5:
        return (s[2] == kv and s[3] == g) or (s[1] == kv and s[2] == g)
    return False


def _expands(si: tuple, so: tuple, h: int, kv: int, g: int, hd: int) -> bool:
    """Whether an (input shape, output shape) pair is one step of the
    KV -> H expansion:

      * same rank, exactly one axis differing, KV -> H (the repeat's final
        shape, or a gather/tile doing it in one step);
      * same rank, a singleton group axis right of KV growing 1 -> G;
      * rank+1 with a G axis inserted right of KV.
    """
    if not si or not so or si[-1] != hd or so[-1] != hd:
        return False
    if len(si) == len(so):
        diff = [i for i in range(len(si)) if si[i] != so[i]]
        if len(diff) != 1:
            return False
        i = diff[0]
        if si[i] == kv and so[i] == h:
            return True
        return si[i] == 1 and so[i] == g and i > 0 and si[i - 1] == kv
    if len(so) == len(si) + 1:
        for i in range(1, len(so) - 1):
            if (so[i] == g and so[i - 1] == kv
                    and so[:i] + so[i + 1:] == si):
                return True
    return False


def _step(rec, h, kv, g, hd) -> bool:
    return any(_is_suspect(si.shape, kv, hd)
               and _expands(si.shape, so.shape, h, kv, g, hd)
               for si in rec.inputs for so in rec.outputs)


def find_head_broadcasts(trace, h: int, kv: int, hd: int) -> list:
    """Records of `trace` that materialize a KV -> H head expansion for
    the (h, kv, hd) geometry.

    An expansion step done by a view (``expand``) marks its result, and
    views of a marked tensor stay marked; the first materializing op that
    reads a marked tensor is the finding.  A materializing op that does a
    step itself is a finding too, unless it already reads an expanded
    operand (anything touching the H-shaped query, or the copy after an
    expansion already flagged).  MHA geometries (G < 2) have nothing to
    expand.
    """
    if kv <= 0 or h % kv or h // kv < 2:
        return []
    g = h // kv
    pending: set = set()
    flagged = []
    for rec in trace.records:
        marked = any(t.source is not None and t.source[0] == "record"
                     and t.source[1] in pending for t in rec.inputs)
        if rec.name in trace_lib.VIEW_OPS:
            if marked or (not any(_is_expanded(t.shape, h, kv, g, hd)
                                  for t in rec.inputs)
                          and _step(rec, h, kv, g, hd)):
                pending.add(rec.index)
            continue
        if rec.name not in MATERIALIZING:
            continue
        if marked:
            flagged.append(rec)
        elif (not any(_is_expanded(t.shape, h, kv, g, hd)
                      for t in rec.inputs) and _step(rec, h, kv, g, hd)):
            flagged.append(rec)
    return flagged


@lint.register_rule(RULE_ID, title="no-head-broadcast", severity=SEVERITY)
def check(ctx: lint.LintContext) -> list:
    """No op materializes a KV-shaped K/V operand at H query heads."""
    if ctx.trace is None:
        return []
    findings = []
    seen = set()
    for h, kv, hd in ctx.attention_heads():
        for rec in find_head_broadcasts(ctx.trace, h, kv, hd):
            if rec.index in seen:
                continue
            seen.add(rec.index)
            outs = [t.shape for t in rec.outputs]
            findings.append(lint.Finding(
                rule_id=RULE_ID, severity=SEVERITY,
                op_path=trace_lib.path(rec),
                message=(f"materializes a KV->H head broadcast "
                         f"(H={h}, KV={kv}, head_dim={hd}): "
                         f"{rec.op} -> {outs} — the grouped layout "
                         f"contract keeps K/V compact end-to-end")))
    return findings
