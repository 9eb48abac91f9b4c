"""Named scopes: the port's counterpart of ``jax.named_scope``.

The JAX engine runs every dispatch under ``jax.named_scope("repro.op.<op>")``
and the name lands on the traced equations, where the trace linter reads
it.  PyTorch runs eagerly and keeps no name stack, so the port keeps one:
`named_scope` pushes a name on this thread's stack for the length of a
``with`` block, and `analysis/trace.py` reads the stack at every aten call
it records.  The engine enters ``named_scope(op_scope(op))`` around each
backend call (core/engine.py) and the kernels' backward methods enter
``op_scope("gemm_bwd")`` / ``op_scope("attention_bwd")``, the names of the
JAX package's custom VJPs.

A recorder that wants each registry dispatch's operands and results (the
trace's op boundaries) adds a callable to `OBSERVERS`; the engine calls
`named_scope.boundary` after each dispatch only while the list is not
empty, so nothing is paid when no trace records.

Spans: `span(name)` opens a ``torch.profiler`` range named `name` while
a profiler records, and `named_scope` opens one under its own name, so
every ``repro.op.<op>`` dispatch shows in a profile beside the serving
and model spans (``serve.*``, ``cache.*``, ``darknet.*``).  Spans exist
only while a profiler records: they sit on the profiler's clock, with the
device's kernels and copies that the profile links to their launches.
When no profiler records, a span costs one enabled check and returns one
shared no-op context: nothing is allocated or formatted.  A span leaves
the scope stack as it is, so trace scope paths do not see it.  The range
is an operator range (``_RecordFunctionFast``, ~1.5 µs on the host while
recording), not ``record_function``'s user annotation (~13 µs), which the
profiler also mirrors onto the device's timeline as an event of its own.

This module imports nothing of the port, so the kernels may use it.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# The marker every registry dispatch carries (JAX's string, so messages
# read the same in both packages).
OP_SCOPE_PREFIX = "repro.op."

# Callables (scope, op, inputs, outputs) told of every dispatch boundary
# while they are registered (analysis/trace.py).
OBSERVERS: list = []

_LOCAL = threading.local()
_SERIAL = itertools.count(1)
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records its block as a profiler range named
    `name` while a profiler is active; otherwise a shared no-op."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _OFF


def op_scope(op: str) -> str:
    """The scope name the engine wraps a dispatch of `op` in."""
    return OP_SCOPE_PREFIX + op


def stack() -> tuple:
    """This thread's open scopes, outermost first, as (name, serial)
    pairs; each entry of a scope has a serial of its own."""
    return getattr(_LOCAL, "stack", ())


def path(entries: tuple | None = None) -> str:
    """The '/'-joined names of `entries` (default: this thread's stack)."""
    return "/".join(name for name, _ in (stack() if entries is None
                                          else entries))


def scoped(name: str):
    """Decorator: run the function under ``named_scope(name)`` (the
    kernels' backward methods)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with named_scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


class named_scope:
    """``with named_scope(name):`` runs its block under `name` on this
    thread's scope stack, and inside ``span(name)``.  Nestable; the stack
    is thread-local, so a backward pass on autograd's device thread starts
    from an empty one."""

    __slots__ = ("name", "serial", "_prev", "_span")

    def __init__(self, name: str):
        self.name = name
        self.serial = 0
        self._prev = ()
        self._span = _OFF

    def __enter__(self) -> "named_scope":
        self._prev = stack()
        self.serial = next(_SERIAL)
        _LOCAL.stack = self._prev + ((self.name, self.serial),)
        self._span = span(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        _LOCAL.stack = self._prev
        return False

    def boundary(self, op: str, inputs, outputs) -> None:
        """Tell the observers that the dispatch of `op` in this scope took
        `inputs` and gave `outputs` (tensors, or tuples of them)."""
        for observer in OBSERVERS:
            observer(self, op, inputs, outputs)
