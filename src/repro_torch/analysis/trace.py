"""The port's trace of one run: every aten call, once, with its scope.

JAX's trace linter walks a closed jaxpr (``jax.make_jaxpr``) with the
walkers of ``repro/analysis/lint.py`` (`eqn_subjaxprs`, `walk_eqns_scoped`,
`eqn_path`): each equation has its primitive, its operands' and results'
avals, the name-stack path it was traced under (inherited through call-like
equations) and its operands' origin (an argument, an earlier equation's
result, or a constant of the closed jaxpr).  PyTorch runs eagerly, so the
port records the same facts while the function runs: `record` is a
``TorchDispatchMode`` that sees every aten call below autograd, forward
and backward, and keeps one `Record` for each:

* ``op``: the aten name (``"aten::mm"``);
* ``inputs`` / ``outputs``: each tensor operand's and result's shape,
  dtype and bytes (`TensorInfo`); an input also has its ``source``:
  ``("arg", i)`` (reachable from the traced call's arguments: the tensors
  of the argument trees and of any ``nn.Module`` among them, views of
  their storage included), ``("record", j)`` (a result of record j) or
  ``("const", k)`` (neither: a tensor captured by closure, the eager
  counterpart of a jaxpr constant; k numbers the distinct ones);
* ``scope``: the '/'-joined `repro_torch.scopes` path it ran under, and
  ``region``, the serial of the outermost ``repro.op.*`` scope on this
  thread (None outside every registry op);
* ``backward``: whether autograd's engine ran it, and ``flops``, by
  ``torch.utils.flop_counter``'s formulas (the same decompositions
  ``FlopCounterMode`` makes, so the totals agree).

A backward op runs after the Python scope of its forward has closed, and
on a card on autograd's device thread.  JAX's transposed equations inherit
their forward's name stack; here the recorder stamps each forward autograd
node with its scope (``grad_fn.metadata["scope"]``, when a later call
consumes the node's output, and at each registry boundary for the op's
results) and reads it back through ``torch._C._current_autograd_node()``
in the backward: a backward record's scope is its node's scope joined with
the scopes its backward function opens itself (``repro.op.gemm_bwd``).

Besides the aten records the engine reports each registry dispatch as a
boundary record (``kind == "op"``, ``op`` the registry op's name) with the
operands it took and the results it gave, as ``hlo_cost`` sees a fusion at
its call site: on the `cuda` backend the hand-written kernels launch
through ctypes, so no aten record shows their reads and writes.

It traces on ``cpu``, ``meta`` and ``cuda`` alike.  On ``cuda`` the kernel
launches are not aten calls: what shows is the engine's glue and whatever
bypasses the engine, which is what the lint rules read.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import scopes

# Queries of a tensor's metadata: FlopCounterMode lets them through
# uncounted; they are not computations, so they are not recorded either.
_METADATA_OPS = {getattr(torch.ops.aten, name).default for name in (
    "is_contiguous", "size", "sym_size", "stride", "sym_stride",
    "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim")}
_METADATA_OPS |= {torch.ops.aten.is_contiguous.memory_format,
                  torch.ops.prim.layout.default}


# Ops that write no bytes: the views below autograd (and detach, an
# alias) and allocations.
VIEW_OPS = frozenset({
    "expand", "view", "_unsafe_view", "_reshape_alias", "unsqueeze",
    "squeeze", "permute", "transpose", "t", "as_strided", "slice", "select",
    "alias", "detach", "split", "split_with_sizes", "unbind", "lift_fresh"})
ALLOC_OPS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided"})


class TensorInfo(NamedTuple):
    shape: tuple
    dtype: str          # torch dtype name without "torch."
    nbytes: int
    source: tuple | None = None   # inputs only: ("arg"|"record"|"const", i)


@dataclasses.dataclass(frozen=True)
class Record:
    index: int
    op: str                       # "aten::mm", or a registry op's name
    inputs: tuple                 # TensorInfo per tensor operand
    outputs: tuple                # TensorInfo per tensor result
    scope: str = ""
    region: int | None = None
    backward: bool = False
    flops: int = 0
    kind: str = "aten"            # "aten" | "op" (a registry boundary)

    @property
    def name(self) -> str:
        """The op without its namespace (``"mm"``)."""
        return self.op.rpartition("::")[2]

    @property
    def nbytes(self) -> int:
        """Operand plus result bytes, each read or written once."""
        return (sum(t.nbytes for t in self.inputs)
                + sum(t.nbytes for t in self.outputs))


@dataclasses.dataclass
class Trace:
    """What one recorded run did: `records` (aten calls, in the order they
    ran), `boundaries` (the registry dispatches' boundary records by
    region serial) and the number of argument tensors."""
    records: list = dataclasses.field(default_factory=list)
    boundaries: dict = dataclasses.field(default_factory=dict)
    n_args: int = 0

    def flops(self) -> int:
        return sum(r.flops for r in self.records)


def path(record: Record) -> str:
    """Human-readable location of a record (JAX's `eqn_path`): the op and
    the scope it ran under."""
    where = f"{record.op}@{record.scope}" if record.scope else record.op
    return f"{where} (backward)" if record.backward else where


def argument_tensors(tree) -> list:
    """The tensors of an argument tree, in order: nested dicts, lists and
    tuples, with an ``nn.Module``'s parameters and buffers."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in argument_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in argument_tensors(v)]
    return []


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return None


def _info(t: torch.Tensor, source=None) -> TensorInfo:
    return TensorInfo(tuple(t.shape), str(t.dtype).removeprefix("torch."),
                      t.numel() * t.element_size(), source)


def _region(entries: tuple) -> int | None:
    for name, serial in entries:
        if name.startswith(scopes.OP_SCOPE_PREFIX):
            return serial
    return None


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace, args: tuple):
        super().__init__()
        self.trace = trace
        self._made = WeakIdKeyDictionary()     # tensor -> record index
        self._consts = WeakIdKeyDictionary()   # tensor -> const number
        self._args = WeakIdKeyDictionary()     # tensor -> argument index
        self._arg_storages: dict = {}
        tensors = argument_tensors(args)
        for i, t in enumerate(tensors):
            self._args.setdefault(t, i)
            key = _storage_key(t)
            if key is not None:
                self._arg_storages.setdefault(key, i)
        trace.n_args = len(tensors)
        self._scopes: list = []                # stamped scope per record

    # ---------------------------------------------------------- sources ---
    def _source(self, t: torch.Tensor) -> tuple:
        j = self._made.get(t)
        if j is not None:
            return ("record", j)
        i = self._args.get(t)
        if i is None:
            i = self._arg_storages.get(_storage_key(t))
        if i is not None:
            return ("arg", i)
        k = self._consts.get(t)
        if k is None:
            k = self._consts[t] = len(self._consts)
        return ("const", k)

    def _stamp(self, t: torch.Tensor, scope: str) -> None:
        node = t.grad_fn
        if node is not None and "scope" not in node.metadata:
            node.metadata["scope"] = scope

    # --------------------------------------------------------- dispatch ---
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA_OPS or isinstance(
                func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        # as FlopCounterMode: an op without a formula runs as its
        # decomposition where it has one, whose pieces are recorded
        if (func not in flop_counter.flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        node = torch._C._current_autograd_node()
        entries = scopes.stack()
        own = scopes.path(entries)
        if node is not None:
            outer = node.metadata.get("scope", "")
            scope = "/".join(s for s in (outer, own) if s)
        else:
            scope = own
        ins = argument_tensors((args, kwargs))
        inputs = tuple(_info(t, self._source(t)) for t in ins)
        if node is None:
            # a forward node's scope is its producer's (see module doc)
            for t in ins:
                j = self._made.get(t)
                self._stamp(t, self._scopes[j] if j is not None else "")
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = (flop_counter.flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
                 if packet in flop_counter.flop_registry else 0)
        outs = argument_tensors(out)
        index = len(self.trace.records)
        self.trace.records.append(Record(
            index, func._schema.name, inputs,
            tuple(_info(t) for t in outs), scope, _region(entries),
            node is not None, int(flops)))
        self._scopes.append(scope)
        for t in outs:
            self._made[t] = index
        return out

    # ---------------------------------------------------- op boundaries ---
    def boundary(self, scope, op, inputs, outputs) -> None:
        entries = scopes.stack()
        if _region(entries) != scope.serial:
            return   # a dispatch nested inside another registry op
        node = torch._C._current_autograd_node()
        where = scopes.path(entries)
        if node is not None:
            where = "/".join(s for s in (node.metadata.get("scope", ""),
                                         where) if s)
        outs = argument_tensors(outputs)
        for t in outs:
            self._stamp(t, where)
        self.trace.boundaries[scope.serial] = Record(
            len(self.trace.boundaries), op,
            tuple(_info(t, self._source(t)) for t in argument_tensors(inputs)),
            tuple(_info(t) for t in outs), where, scope.serial,
            node is not None, 0, "op")


@contextlib.contextmanager
def record(*args):
    """``with record(*args) as trace:`` records every aten call of the
    block into `trace` (a `Trace`); `args` are the traced call's
    arguments, the roots of ``("arg", i)`` sources."""
    trace = Trace()
    recorder = _Recorder(trace, args)
    scopes.OBSERVERS.append(recorder.boundary)
    try:
        with recorder:
            yield trace
    finally:
        scopes.OBSERVERS.remove(recorder.boundary)


def trace_call(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under `record`.  Returns
    ``(trace, result)``."""
    with record(args, kwargs) as trace:
        out = fn(*args, **kwargs)
    return trace, out
