"""The port's trace-lint (`repro_torch.analysis.lint`) held against the JAX
package's (`repro.analysis.lint`).

* One test per case of tests/test_lint.py: every rule fires on its
  intentionally bad fixture (and only its rule), the shipped configs lint
  clean, `CompiledNetwork.lint()`, `Network.compile(lint=...)`,
  suppressions, the report, the JSON CLI and the dispatch log feeding
  R004.
* Zoo parity: for all 13 configs of `lint_config`, the port on `eager`
  gives JAX's finding counts by (rule, severity) on `xla`, but for one
  stated difference: mamba2-1.3b and zamba2-7b, where JAX's six R002
  findings are the SSD einsums of `ssd_chunked`
  (src/repro/models/ssm.py:125-154), a registry op (`ssd`) in the port.
  The SSM decode step's raw einsums give the same R002 counts in both
  (each ``ssm_decode`` and ``ssd_reference``; a whole step's count is
  JAX's times the mamba layers: JAX's layer scan holds each equation
  once).
* `value_and_grad` of reduced qwen2's loss gives no finding in either
  package; under `mixed` the prefill's R003 upcasts are JAX's, layer by
  layer.
* `trace_cost`: FLOPs equal ``FlopCounterMode``'s; one GEMM's bytes equal
  JAX `hlo_cost.analyze`'s for one dot.

JAX's linter reads ``jax.core.ClosedJaxpr`` / ``jax.core.Jaxpr``, which
jax 0.9.0 moved to ``jax.extend.core``; the `jax_lint` fixture aliases
them for this module only (a `pytest.MonkeyPatch` context, undone at the
module's end), so tests/test_lint.py sees the package as it is.
"""
import collections
import json
import warnings

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import hlo_cost as jax_hlo_cost
from repro.configs import base as jax_base
from repro.core import make_engine as jax_make_engine
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tfm
from repro.serve import kvcache as jax_kvcache
from repro.serve import serve_step as jax_serve_step
from repro_torch import scopes
from repro_torch.analysis import lint, trace_cost
from repro_torch.analysis import trace as trace_lib
from repro_torch.configs.base import get_arch, reduced
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.core import backends, make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.kernels import gemm
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.serve import kvcache, serve_step
from repro_torch.tree import flatten

torch.set_num_threads(1)

B, S, H, KV, HD = 2, 16, 4, 2, 32
ZOO = ("darknet_ref", "darknet19", "segnet_small", *jax_base.ARCH_IDS)
# JAX's R002 on the SSD einsums; `ssd` is a registry op in the port
SSD_EINSUMS = {"mamba2-1.3b": 6, "zamba2-7b": 6}


@pytest.fixture(scope="module")
def jax_lint():
    """JAX's lint module with ``jax.core.ClosedJaxpr`` / ``Jaxpr`` aliased
    to their ``jax.extend.core`` homes for this module's tests only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "ClosedJaxpr", jax.extend.core.ClosedJaxpr,
                   raising=False)
        mp.setattr(jax.core, "Jaxpr", jax.extend.core.Jaxpr, raising=False)
        from repro.analysis import lint as jl
        yield jl


def _only_rule(report, rule_id):
    assert report.findings, f"{rule_id} did not fire"
    assert {f.rule_id for f in report.findings} == {rule_id}


def _ctx(fn, *args, **kw):
    trace, _ = trace_lib.trace_call(fn, *args)
    return lint.LintContext(trace=trace, **kw)


def _counts(report) -> collections.Counter:
    return collections.Counter((f.rule_id, f.severity)
                               for f in report.findings)


def _cpu(backend="eager", policy="fp32_strict"):
    return make_engine(backend, policy, device="cpu")


# ------------------------------------------------------- bad fixtures ---

def test_r001_fires_on_explicit_repeat():
    """The retired formulation, k.repeat_interleave(G, dim=2), trips R001
    at the copy that writes the expanded K out."""
    ctx = _ctx(lambda k: k.repeat_interleave(H // KV, dim=2),
               torch.zeros(B, S, KV, HD), head_hints=((H, KV, HD),))
    report = lint.run_lint(ctx)
    _only_rule(report, "R001")
    assert len(report.findings) == 1
    assert "KV->H" in report.findings[0].message


@pytest.mark.parametrize("form", ["expand_reshape", "repeat", "index_select",
                                  "cat", "kernel_order"])
def test_r001_fires_on_each_materializing_form(form):
    """Every way of writing K out at H heads is one finding: a copying
    reshape after ``expand`` (the expand itself copies nothing), repeat,
    index_select along the head axis, cat of G copies, and the kernel
    (B, heads, S, hd) axis order."""
    g = H // KV
    fns = {
        "expand_reshape": lambda k: k[:, :, :, None].expand(
            B, S, KV, g, HD).reshape(B, S, H, HD),
        "repeat": lambda k: k.repeat(1, 1, g, 1),
        "index_select": lambda k: k.index_select(
            2, torch.arange(H) // g),
        "cat": lambda k: torch.cat([k] * g, dim=2),
        "kernel_order": lambda k: k.transpose(1, 2).repeat_interleave(
            g, dim=1),
    }
    ctx = _ctx(fns[form], torch.zeros(B, S, KV, HD),
               head_hints=((H, KV, HD),))
    report = lint.run_lint(ctx)
    _only_rule(report, "R001")
    assert len(report.findings) == 1, report.format()


def test_r001_silent_without_grouping():
    """MHA geometry (G == 1) has nothing to expand; no head hints means
    no geometry to check; an expand that is never copied is a view."""
    fn = lambda k: k.repeat_interleave(2, dim=2)  # noqa: E731
    mha = _ctx(fn, torch.zeros(B, S, KV, HD), head_hints=((H, H, HD),))
    assert not lint.run_lint(mha, rules=("R001",)).findings
    assert not lint.run_lint(_ctx(fn, torch.zeros(B, S, KV, HD)),
                             rules=("R001",)).findings
    view = _ctx(lambda k: k[:, :, :, None].expand(B, S, KV, 2, HD),
                torch.zeros(B, S, KV, HD), head_hints=((H, KV, HD),))
    assert not lint.run_lint(view, rules=("R001",)).findings


def test_r002_fires_on_raw_einsum():
    """A contraction emitted outside the engine (raw torch.einsum) trips
    R002; the same math through `ComputeEngine.matmul` is clean."""
    x, w = torch.zeros(4, 8), torch.zeros(8, 16)
    report = lint.run_lint(_ctx(lambda x, w: torch.einsum("bk,kn->bn", x, w),
                                x, w))
    _only_rule(report, "R002")
    assert "aten::" in report.findings[0].message
    eng = _cpu()
    good = _ctx(lambda x, w: eng.matmul(x, w), x, w)
    assert not lint.run_lint(good, rules=("R002",)).findings


def test_r002_scope_inherited_through_kernel_call():
    """The kernel wrapper's GEMM runs inside the engine's scope and its
    backward under the forward node's scope plus ``repro.op.gemm_bwd``
    (`GemmFused.backward`), carried across autograd: a test-local backend
    whose matmul is the `cuda` wrapper (its plain version on CPU tensors)
    lints clean through a value_and_grad."""
    backends.register_backend(
        "kernel_cpu", {"matmul": lambda x, w, scale, shift, *, act,
                       out_dtype, ctx: kernel_ops.matmul(
                           x, w, scale, shift, act=act,
                           out_dtype=out_dtype)})
    try:
        eng = _cpu("kernel_cpu")
        x = torch.randn(16, 256, requires_grad=True)
        w = torch.randn(256, 128, requires_grad=True)

        def value_and_grad(x, w):
            loss = eng.matmul(x, w, act="relu").sum()
            return loss, torch.autograd.grad(loss, (x, w))

        ctx = _ctx(value_and_grad, x, w)
        assert not lint.run_lint(ctx, rules=("R002",)).findings
        back = [r for r in ctx.trace.records if r.backward
                and r.name == "mm"]
        assert len(back) == 2                      # dX and dW
        assert all(r.scope == "repro.op.matmul/repro.op.gemm_bwd"
                   for r in back), [r.scope for r in back]
    finally:
        backends.unregister_backend("kernel_cpu")
    assert "kernel_cpu" not in backends.list_backends()
    backends.unregister_backend("kernel_cpu")      # absent: a no-op


def test_r003_fires_on_fp64_leak():
    ctx = _ctx(lambda x: x * 2.0, torch.zeros(4, dtype=torch.float64))
    report = lint.run_lint(ctx)
    _only_rule(report, "R003")
    assert all(f.severity == "error" for f in report.findings)
    assert "float64" in report.findings[0].message


def test_r003_weak_typed_entry_has_no_counterpart():
    """JAX warns on a weakly-typed entry (a Python scalar argument).
    PyTorch tensors carry no weak type, so the port has no such check:
    the same function lints clean (a difference by design)."""
    ctx = _ctx(lambda x, s: x * s, torch.zeros(4), 2.0)
    assert not lint.run_lint(ctx, rules=("R003",)).findings


def test_r003_upcast_outside_dispatch_warns():
    ctx = _ctx(lambda x: x.float() + 1.0, torch.zeros(4, dtype=torch.bfloat16))
    report = lint.run_lint(ctx, rules=("R003",))
    assert [f.severity for f in report.findings] == ["warning"]
    assert "upcast" in report.findings[0].message
    # the same upcast inside a registry op's scope is a declared accumulator
    def scoped(x):
        with scopes.named_scope(scopes.op_scope("matmul")):
            return x.float() + 1.0
    inside = _ctx(scoped, torch.zeros(4, dtype=torch.bfloat16))
    assert not lint.run_lint(inside, rules=("R003",)).findings


def test_r004_fires_on_misaligned_plan():
    """A corrupt tile plan (as a persisted table would replay it) trips
    R004 with the plan and the kernels' plans named."""
    ctx = lint.LintContext(op_log=(
        {"backend": "cuda", "op": "matmul", "shapes": (64, 256, 128),
         "dtype": "float32", "tiles": ("A", 12, 100)},))
    report = lint.run_lint(ctx)
    _only_rule(report, "R004")
    msg = report.findings[0].message
    assert "bm=12" in msg and "bn=100" in msg and "instantiated" in msg


def test_r004_catches_an_illegal_plan_via_dispatch_log():
    """End to end: a backend whose picker resolves an illegal plan leaves
    it in the dispatch log, where R004 finds it."""
    bad = gemm.Plan("A", 12, 128)
    backends.register_backend(
        "pinned", {"matmul": backends.get_backend("eager").op("matmul")},
        tile_picker=lambda op, shapes, dtype: tuple(bad))
    backends.clear_tile_cache()
    try:
        eng = _cpu("pinned")
        report = lint.lint_traced(lambda x, w: eng.matmul(x, w),
                                  torch.zeros(16, 256), torch.zeros(256, 128),
                                  backend="pinned", compile_hlo=False)
    finally:
        backends.unregister_backend("pinned")
        backends.clear_tile_cache()
    _only_rule(report, "R004")
    assert "bm=12" in report.findings[0].message


def test_r004_attention_and_malformed_plans():
    q, k = (B, S, H, HD), (B, S, KV, HD)
    assert backends.validate_tiles("attention", (q, k), "float32",
                                   (12, 100, 3))
    assert backends.validate_tiles("attention_bwd", (q, k), "float32",
                                   (12,))
    # malformed plans/shapes come back as problems, never exceptions
    assert backends.validate_tiles("matmul", (64, 256, 128), "float32",
                                   (8, 128))
    assert backends.validate_tiles("matmul", ("garbage",), "float32",
                                   ("A", 64, 64))
    # the heuristic picks are legal
    pick = kernel_ops.default_tiles(64, 256, 128)
    assert not backends.validate_tiles("matmul", (64, 256, 128), "float32",
                                       pick)
    apick = backends.get_backend("cuda").tile_picker("attention", (q, k),
                                                      "float32")
    assert not backends.validate_tiles("attention", (q, k), "float32",
                                       apick)


def test_r005_fires_on_baked_constant():
    big = torch.ones(1024, 1024)                    # 4 MiB closure tensor
    ctx = _ctx(lambda x: x + big, torch.zeros(1024, 1024))
    report = lint.run_lint(ctx)
    _only_rule(report, "R005")
    assert "4194304 bytes" in report.findings[0].message
    # threshold is honored; an argument is never a constant
    loose = _ctx(lambda x: x + big, torch.zeros(1024, 1024),
                 const_threshold=1 << 23)
    assert not lint.run_lint(loose, rules=("R005",)).findings
    passed = _ctx(lambda x, b: x + b, torch.zeros(1024, 1024), big)
    assert not lint.run_lint(passed, rules=("R005",)).findings


# ---------------------------------------------------- clean shipped nets ---

def test_darknet_compiled_network_lints_clean():
    net = Network(DARKNET_SMALL_CFG, _cpu())
    cn = net.compile(batch_size=2)
    report = cn.lint()
    assert report.findings == [], report.format()
    assert report.ok
    assert report.hlo_totals and report.hlo_totals["flops"] > 0
    # the capture that feeds the linter kept the single-build invariant
    assert cn.trace_count == 1
    assert cn.trace is not None and cn.trace.records
    assert len(cn.op_log) == sum(cn.op_counts.values())
    assert not hasattr(cn, "hlo_text")            # no counterpart


def test_qwen2_prefill_lints_clean():
    """The LM gate config on `eager`: the trace rules plus R004 over the
    dispatch log (compile_hlo off: no trace-cost totals)."""
    cfg = reduced(get_arch("qwen2-0.5b"))              # H=4, KV=2 GQA
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    step = serve_step.make_prefill_step(_cpu(), cfg)
    with torch.inference_mode():
        report = lint.lint_traced(
            step, params, {"tokens": torch.zeros((B, S), dtype=torch.long)},
            backend="eager", label="qwen2-prefill",
            head_hints=((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),),
            compile_hlo=False)
    assert report.findings == [], report.format()
    assert report.hlo_totals is None


# -------------------------------------------------- integration surfaces ---

def test_compile_lint_gate_warn_and_error():
    net = Network(DARKNET_SMALL_CFG, _cpu())
    # clean network: no warning, artifact returned
    cn = net.compile(batch_size=1, lint="error")
    assert cn.trace_count == 1
    with pytest.raises(ValueError, match="lint mode"):
        net.compile(batch_size=1, lint="bogus")

    @lint.register_rule("T900", title="always-fires", severity="error")
    def _always(ctx):
        return [lint.Finding(rule_id="T900", severity="error",
                             op_path="test", message="planted finding")]

    try:
        with pytest.raises(lint.LintError, match="T900"):
            net.compile(batch_size=1, lint="error")
        with pytest.warns(UserWarning, match="T900"):
            cn = net.compile(batch_size=1, lint="warn")
        assert cn.trace_count == 1                   # warn still builds
    finally:
        lint.unregister_rule("T900")


def test_compile_with_lint_keeps_the_build():
    """The trace rides the one build: the outputs, the op plan and the
    dispatch log equal a build without a trace; an artifact built
    without one refuses to lint."""
    net = Network(DARKNET_SMALL_CFG, _cpu())
    linted = net.compile(batch_size=2, lint="error")
    plain = type(linted)(net, 2, trace=False)
    assert plain.trace is None and plain.trace_count == 1
    x = torch.randn(2, *net.in_shape, generator=torch.Generator()
                    .manual_seed(3))
    assert torch.equal(linted(x), plain(x))
    assert linted.op_counts == plain.op_counts
    assert [{k: v for k, v in r.items()} for r in linted.op_log] == [
        {k: v for k, v in r.items()} for r in plain.op_log]
    with pytest.raises(ValueError, match="trace=False"):
        plain.lint()


def test_suppressions():
    ctx = lint.LintContext(op_log=(
        {"backend": "cuda", "op": "matmul", "shapes": (64, 256, 128),
         "dtype": "float32", "tiles": ("A", 12, 128)},))
    full = lint.run_lint(ctx)
    assert full.findings and not full.ok
    by_rule = lint.run_lint(ctx, suppress=("R004",))
    assert by_rule.ok and not by_rule.findings and by_rule.suppressed
    by_path = lint.run_lint(ctx, suppress=("R004:matmul",))
    assert by_path.ok and by_path.suppressed
    miss = lint.run_lint(ctx, suppress=("R004:attention",))
    assert not miss.ok                      # substring doesn't match
    with pytest.raises(ValueError, match="empty rule id"):
        lint.run_lint(ctx, suppress=(":matmul",))
    with pytest.raises(ValueError, match="unknown rule ids"):
        lint.run_lint(ctx, rules=("R999",))


def test_report_shapes_and_registry():
    f = lint.Finding(rule_id="R001", severity="error", op_path="p",
                     message="m")
    assert f.to_dict() == {"rule_id": "R001", "severity": "error",
                           "op_path": "p", "message": "m"}
    with pytest.raises(ValueError, match="severity"):
        lint.register_rule("T901", title="t", severity="fatal")
    with pytest.raises(ValueError, match="already registered"):
        lint.register_rule("R001", title="dup", severity="error")(
            lambda ctx: [])


def test_report_keys_are_jaxs(jax_lint):
    """`to_dict` keeps JAX's keys, hlo_totals included (filled from the
    trace's cost), and the registry holds JAX's rule ids and titles."""
    port = lint.lint_config("darknet_ref", backend="eager",
                            device="cpu").to_dict()
    ref = jax_lint.lint_config("darknet_ref").to_dict()
    assert set(port) == set(ref)
    assert set(port["summary"]) == set(ref["summary"])
    assert set(port["hlo_totals"]) == set(ref["hlo_totals"])
    assert {k: (r.title, r.severity) for k, r in lint.RULES.items()} == {
        k: (r.title, r.severity) for k, r in jax_lint.RULES.items()}


def test_cli_list_rules_and_json(capsys):
    assert lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("R001", "R002", "R003", "R004", "R005"):
        assert rid in out
    assert lint.main(["--config", "darknet_ref", "--json", "--backend",
                      "eager", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["label"] == "darknet_ref"
    assert report["summary"]["errors"] == 0
    assert report["hlo_totals"]["flops"] > 0
    with pytest.raises(ValueError, match="unknown config"):
        lint.lint_config("no-such-net", backend="eager", device="cpu")


def test_cli_defaults_to_the_card():
    """Like every entry point of the port, the CLI runs on the card by
    default and raises when there is none (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.main(["--config", "darknet_ref"])


# ------------------------------------------------------- the JAX parity ---

@pytest.mark.parametrize("name", ZOO)
def test_zoo_counts_match_jax(jax_lint, name):
    """The port's `lint_config` on `eager` gives JAX's counts by (rule,
    severity) on `xla`, with the SSD einsums of mamba2 / zamba2 the one
    stated difference."""
    want = _counts(jax_lint.lint_config(name))
    got = _counts(lint.lint_config(name, backend="eager", device="cpu"))
    if name in SSD_EINSUMS:
        assert want[("R002", "error")] == SSD_EINSUMS[name]
        del want[("R002", "error")]
    assert got == want


def _mamba_decode_inputs(rng, cfg):
    """One mamba layer's decode inputs as numpy (params, x, cache)."""
    h, hp, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                   cfg.ssm_ngroups)
    di, conv, d = cfg.ssm_d_inner, cfg.ssm_conv, cfg.d_model
    f = np.float32
    p = {"wz": rng.standard_normal((d, di)).astype(f),
         "wx": rng.standard_normal((d, di)).astype(f),
         "wB": rng.standard_normal((d, g * n)).astype(f),
         "wC": rng.standard_normal((d, g * n)).astype(f),
         "wdt": rng.standard_normal((d, h)).astype(f),
         "conv_x": rng.standard_normal((conv, di)).astype(f),
         "conv_x_b": np.zeros(di, f),
         "conv_B": rng.standard_normal((conv, g * n)).astype(f),
         "conv_B_b": np.zeros(g * n, f),
         "conv_C": rng.standard_normal((conv, g * n)).astype(f),
         "conv_C_b": np.zeros(g * n, f),
         "dt_bias": np.zeros(h, f), "A_log": np.zeros(h, f),
         "D": np.ones(h, f), "norm": {"scale": np.ones(di, f)},
         "out": rng.standard_normal((di, d)).astype(f)}
    x = rng.standard_normal((2, 1, d)).astype(f)
    cache = {"conv_x": np.zeros((2, conv - 1, di), f),
             "conv_B": np.zeros((2, conv - 1, g * n), f),
             "conv_C": np.zeros((2, conv - 1, g * n), f),
             "ssm": np.zeros((2, h, hp, n), f)}
    return p, x, cache


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _r002(report) -> int:
    return _counts(report)[("R002", "error")]


def test_ssm_decode_raw_einsums_match_jax(jax_lint):
    """The decode step's raw einsums (the conv step's three and the state
    read: JAX ssm.py:216,231, port ssm.py:119,151) and the reference
    recurrence's (JAX :273, port :193, one a row) give equal R002 counts;
    a whole decode step's is JAX's times the mamba layers (JAX's layer
    scan holds each equation once)."""
    cfg = reduced(get_arch("mamba2-1.3b"))
    jcfg = jax_base.reduced(jax_base.get_arch("mamba2-1.3b"))
    p, x, cache = _mamba_decode_inputs(np.random.default_rng(0), cfg)
    jeng, eng = jax_make_engine("xla"), _cpu()
    want = jax_lint.lint_traced(
        lambda p, x, c: jax_ssm.ssm_decode(jeng, p, x, c, jcfg),
        p, x, cache, backend="xla", compile_hlo=False)
    got = lint.lint_traced(
        lambda p, x, c: ssm.ssm_decode(eng, p, x, c, cfg),
        _torch_tree(p), torch.from_numpy(x), _torch_tree(cache),
        backend="eager", compile_hlo=False)
    assert _r002(got) == _r002(want) == 4
    rng = np.random.default_rng(1)
    s, h, hp, g, n = 5, 4, 8, 2, 16
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((1, s, h, hp), (1, s, h), (h,), (1, s, g, n), (1, s, g, n))]
    want = jax_lint.lint_traced(jax_ssm.ssd_reference, *arrs,
                                backend="xla", compile_hlo=False)
    got = lint.lint_traced(ssm.ssd_reference,
                           *[torch.from_numpy(a) for a in arrs],
                           backend="eager", compile_hlo=False)
    assert _r002(got) == _r002(want) == s
    # a whole decode step
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    want = jax_lint.lint_traced(
        jax_serve_step.make_decode_step(jeng, jcfg), jparams,
        jax_kvcache.cache_init(jcfg, 2, 32), jnp.zeros((2, 1), jnp.int32),
        jnp.int32(3), backend="xla", compile_hlo=False)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = lint.lint_traced(
            serve_step.make_decode_step(eng, cfg), params,
            kvcache.cache_init(cfg, 2, 32), torch.zeros((2, 1),
                                                        dtype=torch.long),
            torch.tensor(3), backend="eager", compile_hlo=False)
    assert _r002(got) == _r002(want) * cfg.n_layers


def test_value_and_grad_lints_clean_in_both(jax_lint):
    """The loss and every gradient of reduced qwen2: no finding in either
    package; the backward's contractions carry their forward's scope."""
    jcfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    cfg = reduced(get_arch("qwen2-0.5b"))
    hints = ((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jeng = jax_make_engine("xla")
    want = jax_lint.lint_traced(
        jax.value_and_grad(lambda p, b: jax_tfm.loss_fn(jeng, jcfg, p, b,
                                                        ce_chunk=S)),
        jax_tfm.init_params(jax.random.PRNGKey(0), jcfg),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)},
        backend="xla", head_hints=hints, compile_hlo=False)
    eng = _cpu()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    leaves = list(flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)

    def value_and_grad(p, b):
        loss = tfm.loss_fn(eng, cfg, p, b, ce_chunk=S)
        return loss, torch.autograd.grad(loss, leaves)

    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)}
    mark = backends.dispatch_log_size()
    trace, _ = trace_lib.trace_call(value_and_grad, params, batch)
    got = lint.run_lint(lint.LintContext(
        trace=trace, op_log=tuple(backends.dispatch_log()[mark:]),
        head_hints=hints))
    assert want.findings == [] and got.findings == [], got.format()
    back = [r for r in trace.records if r.backward and r.name in
            ("mm", "bmm")]
    assert back and all(scopes.OP_SCOPE_PREFIX in r.scope for r in back)


def test_mixed_prefill_upcasts_match_jax_layer_by_layer(jax_lint):
    """Under `mixed` the prefill's R003 warnings are JAX's upcasts: the
    same input shapes, each layer's counted once a layer in the port
    (JAX's layer scan holds them once: 7 there, 6 x 2 layers + 1 here)."""
    jcfg = jax_base.reduced(jax_base.get_arch("qwen2-0.5b"))
    cfg = reduced(get_arch("qwen2-0.5b"))
    tokens = np.zeros((B, S), np.int64)
    jax_step = jax_serve_step.make_prefill_step(
        jax_make_engine("xla", "mixed"), jcfg)
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    closed = jax.make_jaxpr(jax_step)(jparams,
                                      {"tokens": jnp.asarray(tokens)})
    want_shapes = collections.Counter(
        tuple(eqn.invars[0].aval.shape)
        for eqn, scope in jax_lint.walk_eqns_scoped(closed.jaxpr)
        if eqn.primitive.name == "convert_element_type"
        and "repro.op." not in scope
        and str(eqn.params["new_dtype"]) == "float32"
        and str(eqn.invars[0].aval.dtype) == "bfloat16")
    want = jax_lint.run_lint(jax_lint.LintContext(jaxpr=closed),
                             rules=("R003",))
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ctx = _ctx(serve_step.make_prefill_step(_cpu(policy="mixed"), cfg),
                   params, {"tokens": torch.from_numpy(tokens)})
    got = lint.run_lint(ctx, rules=("R003",))
    assert len(want.findings) == 7
    assert len(got.findings) == 6 * cfg.n_layers + 1
    assert {f.severity for f in got.findings} == {"warning"}
    got_shapes = collections.Counter(
        r.inputs[0].shape for r in ctx.trace.records
        if r.name == "_to_copy" and not r.region
        and r.inputs[0].dtype == "bfloat16"
        and r.outputs[0].dtype == "float32")
    assert set(got_shapes) == set(want_shapes)
    # the norms' (B, S, D) upcasts: two a layer and the final norm's
    assert got_shapes[(B, S, cfg.d_model)] == 2 * cfg.n_layers + 1
    assert want_shapes[(B, S, cfg.d_model)] == 3   # two in the body
    for shape, n in want_shapes.items():            # rope: q / k halves
        if shape != (B, S, cfg.d_model):
            assert got_shapes[shape] == n * cfg.n_layers


# -------------------------------------------------------- the trace cost ---

def test_trace_cost_flops_equal_flop_counter_mode():
    """`trace_cost.analyze`'s FLOPs equal FlopCounterMode's on the same
    step: a prefill and a value_and_grad (the recompute included)."""
    cfg = reduced(get_arch("qwen2-0.5b"))
    eng = _cpu()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.zeros((B, S), dtype=torch.long)
    step = serve_step.make_prefill_step(eng, cfg)

    def prefill():
        with torch.inference_mode():
            return step(params, {"tokens": tokens})

    leaves = list(flatten(params).values())

    def grad():
        for t in leaves:
            t.requires_grad_(True)
        loss = tfm.loss_fn(eng, cfg, params, {"tokens": tokens,
                                              "labels": tokens}, ce_chunk=8)
        return torch.autograd.grad(loss, leaves)

    for fn in (prefill, grad):
        with FlopCounterMode(display=False) as counter:
            fn()
        trace, _ = trace_lib.trace_call(fn)
        assert trace_cost.analyze(trace)["flops"] == \
            counter.get_total_flops() > 0


def test_one_gemm_bytes_equal_hlo_cost():
    """One GEMM's bytes: operands plus result, each once, as JAX
    `hlo_cost.analyze` counts one dot; the engine's dispatch is counted
    at its boundary (its interior not again)."""
    m, k, n = 64, 96, 32
    text = jax.jit(lambda x, w: jnp.dot(x, w)).lower(
        jnp.zeros((m, k)), jnp.zeros((k, n))).compile().as_text()
    want = jax_hlo_cost.analyze(text)
    x, w = torch.zeros(m, k), torch.zeros(k, n)
    raw, _ = trace_lib.trace_call(torch.mm, x, w)
    eng = _cpu()
    engine, _ = trace_lib.trace_call(lambda x, w: eng.matmul(x, w), x, w)
    assert trace_cost.analyze(raw)["bytes"] == want["bytes"] == \
        4 * (m * k + k * n + m * n)
    assert trace_cost.analyze(engine)["bytes"] == want["bytes"]
    assert trace_cost.analyze(engine)["flops"] == want["flops"] == \
        2 * m * k * n
    assert list(engine.boundaries.values())[0].op == "matmul"


def test_trace_sources_and_scopes():
    """Each operand's origin: an argument (a module's parameters
    included), an earlier record, or a closure tensor numbered once."""
    lin = torch.nn.Linear(4, 3)
    table = torch.ones(3)
    trace, _ = trace_lib.trace_call(lambda m, x: m(x) * table + table,
                                    lin, torch.zeros(2, 4))
    srcs = [t.source for r in trace.records for t in r.inputs]
    kinds = {s[0] for s in srcs}
    assert kinds == {"arg", "record", "const"}
    assert {s for s in srcs if s[0] == "const"} == {("const", 0)}
    assert trace.n_args == 3                    # weight, bias, x
    with scopes.named_scope("outer"):
        with scopes.named_scope(scopes.op_scope("bmm")) as inner:
            assert scopes.path() == "outer/repro.op.bmm"
            assert scopes.stack()[-1] == ("repro.op.bmm", inner.serial)
    assert scopes.stack() == ()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert backends.op_scope("matmul") == "repro.op.matmul"
