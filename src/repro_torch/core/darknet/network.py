"""Darknet network builder: cfg sections -> parameters + forward (PyTorch
port of ``repro/core/darknet/network.py``).

Mirrors the paper's flow (Fig. 1): parse the Darknet description, map every
conv/deconv/FC layer onto the compute engine, keep the rest as cheap
elementwise/pooling glue.  Weights come from `init` or from a state dict
(see `repro_torch.convert.params_from_jax` for the JAX package's trees).

The parameters are trainable (`repro_torch.train`), as the JAX package
differentiates `apply`.  Batch-norm stays in its folded inference form in
training too: ``mean`` and ``var`` are parameters that receive gradients
through `layers.fold_batchnorm`, with no batch statistics and no running
average.  `CompiledNetwork` runs under ``torch.inference_mode()``, so
serving builds no autograd graph.

`Network` is an ``nn.Module``: its parameters are registered under the JAX
tree's keys (``l{i}.w``, ``l{i}.gamma``, ``beta``, ``mean``, ``var``,
``b``), in the same layouts, on the engine's device.  Deployment keeps the
toolflow pattern: `Network.compile(batch_size)` builds a `CompiledNetwork`
for one fixed input, capturing the engine op plan of its one build, and
`Network.compile_cache(buckets)` serves ragged batches through per-bucket
`CompiledNetwork`s.  PyTorch runs eagerly, so a build is one forward on
zeros; CUDA-graph capture per bucket is later work.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
from typing import Any, Iterable

import torch
from torch import nn

from repro_torch.analysis import trace as trace_lib
from repro_torch.core import backends
from repro_torch.core.darknet import cfg as cfg_mod
from repro_torch.core.darknet import layers as L
from repro_torch.core.engine import ComputeEngine, make_engine, synchronize
from repro_torch.scopes import span


@dataclasses.dataclass
class LayerPlan:
    index: int
    type: str
    options: dict[str, Any]
    out_shape: tuple  # (H, W, C) or (N,)
    span: str         # its profiler span's name, "darknet.l{index}.{type}"


class Network(nn.Module):
    """Built from a darknet cfg; `forward(x)` is the JAX `apply(params, x)`
    with this module's parameters.

    `engine` defaults to `make_engine()`: the `cuda` backend on the card.
    Parameters are drawn at construction from `generator` (seed 0 when
    None); `init` redraws them.
    """

    def __init__(self, cfg_text: str, engine: ComputeEngine | None = None,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        self.engine = engine or make_engine()
        self.sections = cfg_mod.parse_cfg(cfg_text)
        net = self.sections[0]
        self.in_shape = (net.get("height"), net.get("width"),
                         net.get("channels"))
        self.plans: list[LayerPlan] = []
        self._plan()
        self.init(generator)

    # ------------------------------------------------------------- planning
    def _plan(self):
        h, w, c = self.in_shape
        shapes: list[tuple] = []
        for i, s in enumerate(self.sections[1:]):
            t = s.type
            if t == "convolutional":
                size, stride = s.get("size", 3), s.get("stride", 1)
                pad = cfg_mod.conv_pad(s, size)
                f = s.get("filters", 1)
                h = (h + 2 * pad - size) // stride + 1
                w = (w + 2 * pad - size) // stride + 1
                c = f
            elif t == "deconvolutional":
                size, stride = s.get("size", 3), s.get("stride", 1)
                pad = cfg_mod.conv_pad(s, size)
                f = s.get("filters", 1)
                h = (h - 1) * stride + size - 2 * pad
                w = (w - 1) * stride + size - 2 * pad
                c = f
            elif t == "maxpool":
                size, stride = s.get("size", 2), s.get("stride", 2)
                pad = s.get("padding", 0)
                h = (h + pad - size) // stride + 1
                w = (w + pad - size) // stride + 1
            elif t == "avgpool":
                h, w = 1, 1
            elif t == "upsample":
                stride = s.get("stride", 2)
                h, w = h * stride, w * stride
            elif t == "route":
                idxs = [j if j >= 0 else len(shapes) + j
                        for j in s.get("layers")]
                h, w, _ = shapes[idxs[0]]
                c = sum(shapes[j][2] for j in idxs)
            elif t == "shortcut":
                pass  # same shape
            elif t == "connected":
                n = s.get("output")
                h, w, c = 1, 1, n
            elif t in ("softmax", "dropout"):
                pass
            else:
                raise ValueError(f"unplanned layer {t}")
            shapes.append((h, w, c))
            self.plans.append(LayerPlan(i, t, dict(s.options), (h, w, c),
                                        f"darknet.l{i}.{t}"))
        self.out_shape = shapes[-1]

    # ----------------------------------------------------------------- init
    def init(self, generator: torch.Generator | None = None) -> "Network":
        """(Re)draw every parameter from `generator` (a CPU generator;
        seed 0 when None) and place it on the engine's device.  He-normal
        weights, BN gamma/beta/mean/var = 1/0/0/1, zero biases, as the JAX
        `Network.init` (whose numbers differ: another generator).
        Returns self."""
        gen = generator or torch.Generator().manual_seed(0)
        cur_c = self.in_shape[2]
        cur_hw = self.in_shape[:2]
        for p in self.plans:
            t, o = p.type, p.options
            if t == "convolutional":
                tensors = L.init_conv(gen, o.get("size", 3), cur_c,
                                      o.get("filters", 1),
                                      o.get("batch_normalize", 0))
            elif t == "deconvolutional":
                tensors = L.init_deconv(gen, o.get("size", 3), cur_c,
                                        o.get("filters", 1),
                                        o.get("batch_normalize", 0))
            elif t == "connected":
                tensors = L.init_connected(gen, cur_hw[0] * cur_hw[1] * cur_c,
                                           o.get("output"))
            else:
                tensors = None
            if tensors is not None:
                self.add_module(f"l{p.index}", nn.ParameterDict({
                    k: nn.Parameter(v.to(self.engine.device))
                    for k, v in tensors.items()}))
            cur_hw, cur_c = p.out_shape[:2], p.out_shape[2]
        return self

    # -------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) on the engine's device -> network output."""
        outputs: list = []
        for p in self.plans:
            with span(p.span):
                x = self._layer(p, x, outputs)
            outputs.append(x)
        return x

    def _layer(self, p: LayerPlan, x: torch.Tensor, outputs: list):
        """One planned layer on `x`; `outputs` holds the earlier layers'."""
        eng = self.engine
        t, o = p.type, p.options
        if t == "convolutional":
            size = o.get("size", 3)
            return L.conv2d(eng, getattr(self, f"l{p.index}"), x, size=size,
                            stride=o.get("stride", 1),
                            pad=cfg_mod.conv_pad(o, size),
                            act=o.get("activation", "leaky"),
                            batch_normalize=bool(o.get("batch_normalize", 0)))
        if t == "deconvolutional":
            size = o.get("size", 3)
            return L.deconv2d(eng, getattr(self, f"l{p.index}"), x,
                              size=size, stride=o.get("stride", 1),
                              pad=cfg_mod.conv_pad(o, size),
                              act=o.get("activation", "leaky"),
                              batch_normalize=bool(
                                  o.get("batch_normalize", 0)))
        if t == "maxpool":
            return L.maxpool(x, size=o.get("size", 2),
                             stride=o.get("stride", 2),
                             pad=o.get("padding", 0))
        if t == "avgpool":
            return L.avgpool_global(x)
        if t == "upsample":
            return L.upsample(x, stride=o.get("stride", 2))
        if t == "route":
            idxs = [j if j >= 0 else p.index + j for j in o["layers"]]
            return L.route([outputs[j] for j in idxs])
        if t == "shortcut":
            j = o["from"]
            j = j if j >= 0 else p.index + j
            return L.shortcut(x, outputs[j],
                              act=o.get("activation", "linear"))
        if t == "connected":
            return L.connected(eng, getattr(self, f"l{p.index}"), x,
                               act=o.get("activation", "linear"))
        if t == "softmax":
            return L.softmax(x)
        return x  # dropout: an inference no-op

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -------------------------------------------------------------- compile
    def compile(self, batch_size: int = 1, *,
                dtype: torch.dtype = torch.float32,
                autotune: str | None = None,
                lint: str | None = None) -> "CompiledNetwork":
        """Build the artifact for a fixed (batch_size, H, W, C) input of
        `dtype`: one forward on zeros, with the engine op plan and the
        trace of that build captured (see `CompiledNetwork`).  This
        replaces ``nn.Module.compile``: the port never runs
        ``torch.compile``.

        `autotune` is an optional policy ("off" | "heuristic" | "measure")
        scoped to the build pass; "measure" is the opt-in measured pass:
        keys first seen there are timed on the card and persisted to the
        per-device table, and their picks serve every later call (the
        cache is memoized whatever the policy).  None inherits the
        process policy.

        `lint` is an optional trace-lint gate (docs/lint.md) over the
        build's trace and dispatch log: "warn" emits a UserWarning
        listing any findings; "error" additionally raises
        `repro_torch.analysis.lint.LintError` on error-severity findings.
        None (the default) skips linting.

        Raises ValueError for an unknown autotune policy or lint mode, and
        `LintError` under ``lint="error"`` when an error-severity finding
        survives."""
        if lint not in (None, "warn", "error"):
            raise ValueError(f"unknown lint mode {lint!r}; choose "
                             f"'warn', 'error' or None")
        cn = CompiledNetwork(self, batch_size, dtype=dtype,
                             autotune=autotune)
        if lint is not None:
            from repro_torch.analysis.lint import LintError
            report = cn.lint()
            if lint == "error" and not report.ok:
                raise LintError(report)
            if report.findings:
                warnings.warn("trace-lint findings:\n" + report.format(),
                              stacklevel=2)
        return cn

    def compile_cache(self, buckets: Iterable[int] = (1, 2, 4, 8), *,
                      dtype: torch.dtype = torch.float32,
                      autotune: str | None = None) -> "CompileCache":
        """Bucketed cache of `CompiledNetwork`s for ragged serving traffic:
        `CompileCache.run(x)` pads a ragged batch up to the smallest bucket
        that fits and slices the real rows back out.  The serving frontend
        (`repro_torch.serve.frontend.CNNServingEngine`) dispatches through
        this.  `autotune` is forwarded to every bucket's build (see
        `compile`)."""
        return CompileCache(self, buckets, dtype=dtype, autotune=autotune)


class CompiledNetwork:
    """Build-once inference artifact for a planned Darknet `Network`.

    Fixed to one (batch_size, H, W, C) input shape and dtype, validated at
    every call.  The one build (a forward on zeros) captures the engine's
    op plan from the registry's dispatch counters (`op_counts`, e.g.
    ``{('cuda', 'conv2d'): 11, ('cuda', 'matmul'): 1}``) and its dispatch
    records (`op_log`), the autotune keys first resolved there
    (`autotune_keys`, `autotune_report()`) and, unless ``trace=False``,
    the build's `trace` (`analysis/trace.py`: every aten call, the
    counterpart of JAX's ``closed_jaxpr``, which `lint()` reads; the
    network's parameters and buffers are its arguments); `trace_count`
    counts builds and stays 1.  Exposes `__call__`, `warmup()`,
    `profile()` and `lint()`.
    """

    def __init__(self, net: Network, batch_size: int, *,
                 dtype: torch.dtype = torch.float32,
                 autotune: str | None = None, trace: bool = True):
        self.net = net
        self.batch_size = batch_size
        self.device = net.engine.device
        self.in_shape = (batch_size, *net.in_shape)
        self.dtype = dtype
        self._builds = 0
        before = backends.dispatch_counts()
        before_tuned = set(backends.autotune_report())
        log_mark = backends.dispatch_log_size()
        policy = (backends.autotune_policy(autotune) if autotune
                  else contextlib.nullcontext())
        x = self._zeros()
        recording = (trace_lib.record(net, x) if trace
                     else contextlib.nullcontext())
        with policy, torch.inference_mode(), recording as recorded:
            net(x)
        self._builds += 1
        self.trace = recorded
        self.op_counts = backends.counts_since(before)
        self.op_log = tuple(backends.dispatch_log()[log_mark:])
        # The autotune records this build resolved first (heuristic,
        # measured, or served from the persisted table).
        self.autotune_keys = tuple(
            k for k in backends.autotune_report() if k not in before_tuned)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.in_shape, dtype=self.dtype,
                           device=self.device)

    @property
    def trace_count(self) -> int:
        return self._builds

    def lint(self, *, suppress=(), const_threshold: int | None = None):
        """Run the trace-lint rules (docs/lint.md) over this artifact's
        build record, its trace and dispatch log; nothing runs again.

        Args:
          suppress: suppression tokens, e.g. ("R005", "R002:ssm").
          const_threshold: R005 byte threshold override.

        Returns a `repro_torch.analysis.lint.LintReport`.  Raises
        ValueError for an artifact built with ``trace=False``.
        """
        if self.trace is None:
            raise ValueError("this artifact was built with trace=False: "
                             "there is no trace to lint")
        from repro_torch.analysis import lint as lint_mod
        return lint_mod.lint_compiled_network(
            self, suppress=suppress, const_threshold=const_threshold)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Run the network on a batch that matches the built spec.

        Raises ValueError when x's shape, dtype or device differs from the
        spec: the artifact never rebuilds.
        """
        if tuple(x.shape) != self.in_shape:
            raise ValueError(f"compiled for input {self.in_shape}, "
                             f"got {tuple(x.shape)}")
        if x.dtype != self.dtype:
            raise ValueError(f"compiled for dtype {self.dtype}, "
                             f"got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"compiled for device {self.device}, "
                             f"got {x.device}")
        with torch.inference_mode():
            return self.net(x)

    def warmup(self) -> "CompiledNetwork":
        """Run one call on zeros and wait for the device.  Returns self."""
        self(self._zeros())
        synchronize(self.device)
        return self

    def autotune_report(self) -> dict[str, dict]:
        """Plan records first resolved during this artifact's build:
        `{key: {pick, est_ms, candidates_timed, source}}` with source one
        of heuristic|measured|persisted."""
        full = backends.autotune_report()
        return {k: full[k] for k in self.autotune_keys if k in full}

    def profile(self, x: torch.Tensor | None = None, reps: int = 3) -> dict:
        """Timed execution: host wall time per call (each call ends in a
        device synchronise) plus the op plan and autotune records captured
        at build.

        Returns `{per_call_s, reps, batch_size, trace_count, op_counts,
        autotune}`.
        """
        if x is None:
            x = self._zeros()
        self(x)
        synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            self(x)
            synchronize(self.device)
        dt = (time.perf_counter() - t0) / reps
        return {"per_call_s": dt, "reps": reps,
                "batch_size": self.batch_size,
                "trace_count": self._builds,
                "op_counts": dict(self.op_counts),
                "autotune": self.autotune_report()}


class CompileCache:
    """Keyed cache of `CompiledNetwork`s for ragged batches.

    Buckets are the supported batch sizes.  `run(x)` picks the smallest
    bucket >= len(x), zero-pads the batch up to it, dispatches ONE
    compiled call, and slices the real rows back, so a ragged request
    stream builds each bucket exactly once (lazily, on first use).
    Batches larger than the top bucket split into top-bucket chunks.

    Padding is sound because every planned layer is row-independent across
    the batch dim (conv/pool/connected/softmax all act per image).  On the
    `cuda` backend the real rows of a padded dispatch are bitwise identical
    to an exact-batch run: the GEMM kernel sums every output element in the
    same order whatever M (no split-K).  On the CPU, ``torch.matmul`` may
    pick its kernel by M, so there they agree to rounding.

    Observability: `hits`/`misses` count bucket lookups; `stats()` reports
    builds, the per-bucket dispatch histogram, the pad-waste fraction
    (padded rows / total dispatched rows) and the autotune keys its builds
    resolved, by source.
    """

    def __init__(self, net: Network, buckets: Iterable[int] = (1, 2, 4, 8),
                 *, dtype: torch.dtype = torch.float32,
                 autotune: str | None = None):
        bs = tuple(sorted({int(b) for b in buckets}))
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.net = net
        self.buckets = bs
        self.dtype = dtype
        self.autotune = autotune
        self._compiled: dict[int, CompiledNetwork] = {}
        self.hits = 0
        self.misses = 0
        self._dispatches = collections.Counter()  # bucket -> n dispatches
        self._rows_real = 0
        self._rows_pad = 0

    def bucket_for(self, n: int) -> int | None:
        """Smallest bucket >= n, or None when n exceeds the top bucket."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def get(self, bucket: int) -> CompiledNetwork:
        """The compiled artifact for a bucket (built on a miss).

        Raises ValueError when `bucket` is not one of the cache's buckets.
        """
        if bucket not in self.buckets:
            raise ValueError(f"{bucket} is not a bucket; have {self.buckets}")
        cn = self._compiled.get(bucket)
        if cn is None:
            self.misses += 1
            # serving never lints: its builds keep no trace
            cn = CompiledNetwork(self.net, bucket, dtype=self.dtype,
                                 autotune=self.autotune, trace=False)
            self._compiled[bucket] = cn
        else:
            self.hits += 1
        return cn

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Dispatch a ragged batch: pad to bucket, one compiled call, slice.

        x: (n, H, W, C) with the cache dtype on the network's device;
        n >= 1.  Batches above the top bucket are processed in top-bucket
        chunks and concatenated.

        Returns the (n, ...) network output for the real rows.  Raises
        ValueError on an empty batch or a dtype differing from the cache's.
        """
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if x.dtype != self.dtype:
            raise ValueError(f"cache built for dtype {self.dtype}, "
                             f"got {x.dtype}")
        top = self.buckets[-1]
        if n > top:
            return torch.cat([self._dispatch(x[i:i + top])
                              for i in range(0, n, top)], dim=0)
        return self._dispatch(x)

    def _dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """One compiled call for at most a top bucket of rows, under the
        ``cache.run`` span (its host enqueue): the bucket, the padding
        (``cache.pad``), the call and the slice."""
        with span("cache.run"):
            n = x.shape[0]
            b = self.bucket_for(n)
            cn = self.get(b)
            xb = x
            if b != n:
                with span("cache.pad"):
                    xb = torch.cat([x, x.new_zeros(
                        (b - n,) + tuple(x.shape[1:]))], dim=0)
            y = cn(xb)
            self._dispatches[b] += 1
            self._rows_real += n
            self._rows_pad += b - n
            return y[:n]

    @property
    def trace_count(self) -> int:
        return sum(cn.trace_count for cn in self._compiled.values())

    def warmup(self) -> "CompileCache":
        """Build and warm every bucket now (otherwise lazy)."""
        for b in self.buckets:
            self.get(b).warmup()
        return self

    def autotune_report(self) -> dict[str, dict]:
        """Union of the plan records resolved by the bucket builds (see
        `CompiledNetwork.autotune_report`)."""
        out: dict[str, dict] = {}
        for cn in self._compiled.values():
            out.update(cn.autotune_report())
        return out

    def stats(self) -> dict:
        total = self._rows_real + self._rows_pad
        tuned = self.autotune_report()
        sources = collections.Counter(r["source"] for r in tuned.values())
        return {
            "buckets": self.buckets,
            "compiled": tuple(sorted(self._compiled)),
            "traces": self.trace_count,
            "hits": self.hits,
            "misses": self.misses,
            "dispatches": dict(self._dispatches),
            "rows_real": self._rows_real,
            "rows_padded": self._rows_pad,
            "pad_waste": (self._rows_pad / total) if total else 0.0,
            "autotune": {"keys": len(tuned), "sources": dict(sources)},
        }
