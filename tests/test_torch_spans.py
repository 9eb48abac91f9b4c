"""The port's spans on its CNN serving path, on the CPU.

`scopes.span` opens a profiler range only while a profiler records, and
`named_scope` opens one under its own name.  A served step then shows as
``serve.step`` over its phases, ``cache.run`` over the layers'
``darknet.l{i}.{type}`` spans, the BN fold and the engine's
``repro.op.<op>`` scopes; with no profiler nothing is recorded, the
served bits are the same either way, and the build trace's scope paths
do not see the spans.
"""
import numpy as np
import pytest
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from repro_torch import scopes
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.serve.frontend import CNNServingEngine, ImageRequest

torch.set_num_threads(1)

BUCKETS = (1, 2, 4)
STEPS = {"padded": 3, "exact": 2}   # requests drained in one step
PREFIXES = ("serve.", "cache.", "darknet.", "repro.op.")


@pytest.fixture(scope="module")
def net():
    return Network(DARKNET_SMALL_CFG, make_engine("eager", device="cpu"),
                   generator=torch.Generator().manual_seed(3))


def _requests(net, n, seed=0):
    rng = np.random.default_rng(seed)
    return [ImageRequest(i, image=rng.standard_normal(
        net.in_shape).astype(np.float32)) for i in range(n)]


def _serve(net, n, profiled=False):
    """One step over `n` requests, at most a top bucket of them; (requests,
    the step's program ranges as (start, end, name) or None)."""
    engine = CNNServingEngine(net.compile_cache(buckets=BUCKETS).warmup())
    reqs = _requests(net, n)
    for r in reqs:
        engine.submit(r)
    drained = min(n, BUCKETS[-1])
    if not profiled:
        assert engine.step() == drained
        return reqs, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert engine.step() == drained
    ranges = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(PREFIXES)]
    return reqs, ranges


def _tree(ranges):
    """Nested (name, [children]) lists from properly nested ranges."""
    root = ("", [])
    stack = [(None, root)]
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack[-1][0] is not None and stack[-1][0] <= s:
            stack.pop()
        node = (name, [])
        stack[-1][1][1].append(node)
        stack.append((e, node))
    return root[1]


def _expected(net, padded, ahead=False):
    layers = []
    for p in net.plans:
        if p.type == "convolutional":
            kids = ([("darknet.fold", [])] if p.options.get(
                "batch_normalize") else []) + [("repro.op.conv2d", [])]
        elif p.type == "connected":
            kids = [("repro.op.matmul", [])]
        else:
            kids = []
        layers.append((p.span, kids))
    run = ([("cache.pad", [])] if padded else []) + layers
    look_ahead = [("serve.stage", []), ("serve.h2d", [])] if ahead else []
    return [("serve.step", [
        ("serve.stage", []), ("serve.h2d", []),
        ("serve.forward", [("cache.run", run)]), *look_ahead,
        ("serve.sync", []), ("serve.d2h", []), ("serve.complete", [])])]


def test_span_is_one_shared_noop_without_a_profiler():
    assert scopes.span("a") is scopes.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(scopes.span("a"), _RecordFunctionFast)


@pytest.mark.parametrize("kind", list(STEPS))
def test_no_profiler_enters_no_record_function(net, kind, monkeypatch):
    entered = []
    real = record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    def fast(name):
        entered.append(name)
        return _RecordFunctionFast(name)
    monkeypatch.setattr(record_function, "__enter__", counting)
    monkeypatch.setattr(scopes, "_RecordFunctionFast", fast)
    reqs, _ = _serve(net, STEPS[kind])
    assert all(r.done for r in reqs)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(net, STEPS[kind])
    assert "serve.step" in entered   # the count sees the spans


@pytest.mark.parametrize("kind", list(STEPS))
def test_profiled_step_gives_the_span_tree(net, kind):
    _, ranges = _serve(net, STEPS[kind], profiled=True)
    assert _tree(ranges) == _expected(net, padded=kind == "padded")
    assert [p.span for p in net.plans][:2] == [
        "darknet.l0.convolutional", "darknet.l1.maxpool"]


def test_profiled_step_stages_the_next_batch_after_the_forward(net):
    """A queue longer than the top bucket: the step's look-ahead stages
    and copies the rest between ``serve.forward`` and ``serve.sync``."""
    _, ranges = _serve(net, BUCKETS[-1] + 2, profiled=True)
    assert _tree(ranges) == _expected(net, padded=False, ahead=True)


@pytest.mark.parametrize("kind", list(STEPS))
def test_profiler_leaves_served_bits(net, kind):
    plain, _ = _serve(net, STEPS[kind])
    traced, _ = _serve(net, STEPS[kind], profiled=True)
    for a, b in zip(plain, traced):
        assert a.result.tobytes() == b.result.tobytes()


def test_build_trace_scopes_do_not_see_spans(net):
    plain = net.compile(2)
    with profile(activities=[ProfilerActivity.CPU]):
        spanned = net.compile(2)
    records = [(r.op, r.scope) for r in spanned.trace.records]
    assert records == [(r.op, r.scope) for r in plain.trace.records]
    scoped = [s for _, s in records if s]
    assert scoped and not any("darknet." in s for s in scoped)
    assert all(s.split("/")[0] == "repro.op.conv2d" for s in scoped
               if "repro.op.conv2d" in s)
