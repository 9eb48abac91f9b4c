"""The dry run: what every (arch x shape x mesh) cell would cost, without a
card (PyTorch port of ``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for 256 or 512 fake devices.  The port
has no compiler to ask; it runs the cell's step once on the ``meta``
device instead (shapes and dtypes, no memory, no arithmetic) on the
`eager` engine: `make_train_step` with AdamW moments and
``ce_chunk=min(512, S)``, `make_prefill_step` (`make_forward_step` for an
encoder) or `make_decode_step` on `kvcache.cache_struct`.  The trace runs
under ``torch.utils.flop_counter.FlopCounterMode`` and the engine's
dispatch log (`core.backends.dispatch_log`), so one step gives

* ``flops_total``: the FLOPs FlopCounterMode counts (matrix products,
  attention and convolutions: the recompute of remat included,
  elementwise work not), and ``flops_per_chip``, that over the chips;
* ``memory``: the per-rank bytes of the step's arguments as the JAX
  package shards them: parameters by `policy.param_pspecs`, AdamW moments
  by `policy.zero1_pspecs`, inputs by `policy.batch_pspecs`, caches
  (decode) by `kvcache.cache_pspecs`, each leaf divided by the mesh dims
  its spec names; ``total`` is JAX's argument bytes;
* ``memory_port``: the same terms as the port's `sharded_cuda` backend
  holds them today, parameters, inputs and caches whole on every rank
  (kernels/sharded.py keeps replicated boundaries) and the moments by
  ZeRO-1 (`optimizer.zero1_init`); ``fits`` says whether that total fits
  in one H100's memory;
* ``collectives``: the paths and collectives `kernels.sharded.predict`
  gives the dispatch log on the mesh, with the ZeRO-1 optimizer's
  gathers (`optimizer.zero1_collectives`) for a train step;
* ``roofline``: `analysis.roofline.Roofline` on the H100's figures, its
  memory term the per-rank argument and output bytes (each read or
  written once), its collective term the collectives' link bytes.

JAX's ``hlo_ops``, ``xla_cost`` and ``memory_analysis`` have no
counterpart: there is no compiled module.  The module sets no JAX option
and no ``XLA_FLAGS``.

A mesh is the production one (16 x 16 over ("data", "model"), with
``multi_pod`` 2 x 16 x 16 over ("pod", "data", "model")) or a ``{dim:
size}`` mapping (`mesh`): no process group is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --both-meshes

writes one JSON record a cell under ``results/dryrun`` (JAX's file names)
and prints one line a cell and ``failures=N``; it exits 1 on any error.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_supported,
                                      get_arch, input_specs)
from repro_torch.core import backends, make_engine
from repro_torch.kernels import sharded
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models import transformer as tfm
from repro_torch.serve import kvcache
from repro_torch.serve.serve_step import (make_decode_step, make_forward_step,
                                          make_prefill_step)
from repro_torch.sharding import policy
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten

META = torch.device("meta")
MEMORY_TERMS = ("params", "moments", "inputs", "caches")


def _flat(tree) -> list:
    """The leaves of a tree of dicts and lists, in order: tensors, spec
    tuples, ``torch.Size``s."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _ranks(spec: tuple, sizes: dict) -> int:
    """The ranks one leaf of `spec` is split over."""
    n = 1
    for s in spec:
        for dim in ((s,) if isinstance(s, str) else (s or ())):
            n *= sizes.get(dim, 1)
    return n


def _shard_bytes(leaves, specs, sizes: dict) -> int:
    """Per-rank bytes of `leaves` ((numel, itemsize) pairs) under their
    `specs` (in the same order; None: whole on every rank)."""
    specs = [()] * len(leaves) if specs is None else specs
    return sum(numel * size // _ranks(spec, sizes)
               for (numel, size), spec in zip(leaves, specs))


def _numels(tensors) -> list:
    return [(t.numel(), t.element_size()) for t in tensors]


def _mesh_of(multi_pod: bool, mesh) -> tuple[str, dict]:
    """(the record's mesh name, {dim: size})."""
    if mesh is None:
        shape, axes = PRODUCTION[bool(multi_pod)]
        return ("multi_pod" if multi_pod else "single_pod",
                dict(zip(axes, shape)))
    sizes = policy.mesh_sizes(mesh)
    return ("x".join(f"{d}{n}" for d, n in sizes.items()) or "one_rank",
            sizes)


def cell_step(cfg, shape, policy_name: str = "fp32_strict",
              num_microbatches: int = 1):
    """One cell's step on the meta device on `eager`: (a thunk that runs
    it once, its argument trees (params, [moments,] inputs[, caches])).
    A train step also builds its AdamW moments; a serving step runs under
    ``torch.inference_mode``."""
    engine = make_engine("eager", policy_name, device=META)
    params = tfm.init_params(cfg, generator=None, device=META)
    inputs = input_specs(cfg, shape)
    if shape.kind == "train":
        state = opt.adamw_init(flatten(params))
        step = make_train_step(engine, cfg, opt.AdamWConfig(),
                               num_microbatches=num_microbatches,
                               ce_chunk=min(512, shape.seq_len))
        return (lambda: step(params, state, inputs)), (params, state,
                                                       inputs)
    if shape.kind == "prefill":
        make = make_forward_step if cfg.is_encoder else make_prefill_step
        prefill = make(engine, cfg)

        def run():
            with torch.inference_mode():
                return prefill(params, inputs)
        return run, (params, inputs)
    caches = kvcache.cache_struct(cfg, shape.global_batch, shape.seq_len,
                                  engine.precision.compute_dtype)
    decode = make_decode_step(engine, cfg)

    def run():
        with torch.inference_mode():
            return decode(params, caches, inputs["token"], inputs["pos"])
    return run, (params, inputs, caches)


@functools.lru_cache(maxsize=4)
def _trace(cfg, shape, policy_name: str, num_microbatches: int):
    """Run the cell's step once on the meta device; returns (FLOPs, the
    dispatch log, seconds).  The trace does not depend on the mesh."""
    run, _ = cell_step(cfg, shape, policy_name, num_microbatches)
    mark, counted = backends.dispatch_log_size(), sum(
        backends.dispatch_counts().values())
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        run()
    seconds = time.perf_counter() - t0
    log = backends.dispatch_log()[mark:]
    if len(log) != sum(backends.dispatch_counts().values()) - counted:
        raise RuntimeError("the dispatch log overflowed during the trace")
    return counter.get_total_flops(), tuple(log), seconds


def memory_terms(cfg, shape, sizes: dict, *, fsdp: bool,
                 strategy: str = "tp", policy_name: str = "fp32_strict"
                 ) -> tuple[dict, dict, int]:
    """(memory, memory_port, output bytes) of one cell on a mesh of
    `sizes`, per rank (see the module docstring).  The outputs, each
    written once: the updated parameters and moments of a train step;
    the last position's fp32 logits (sharded as the inputs' batch) and
    the caches of a serving step."""
    dtype = torch.float32 if policy_name == "fp32_strict" else torch.bfloat16
    B, S = shape.global_batch, shape.seq_len
    pleaves = [(math.prod(shape), 4)     # fp32 parameters
               for shape in _flat(policy.stacked_shapes(cfg))]
    params = _shard_bytes(pleaves, _flat(policy.param_pspecs(
        cfg, sizes, fsdp=fsdp, strategy=strategy)), sizes)
    moments = (2 * _shard_bytes(pleaves, _flat(policy.zero1_pspecs(
        cfg, sizes, strategy=strategy)), sizes)
        if shape.kind == "train" else 0)
    inputs = input_specs(cfg, shape)
    ispecs = policy.batch_pspecs(inputs, sizes, strategy=strategy)
    ileaves = _numels(inputs.values())
    caches = caches_whole = out_caches = 0
    if not cfg.is_encoder and shape.kind in ("prefill", "decode"):
        cleaves = _numels(_flat(kvcache.cache_struct(cfg, B, S, dtype)))
        out_caches = _shard_bytes(cleaves, _flat(
            kvcache.cache_pspecs(cfg, sizes, B, S)), sizes)
        if shape.kind == "decode":
            caches = out_caches
            caches_whole = _shard_bytes(cleaves, None, {})
    memory = {"params": params, "moments": moments,
              "inputs": _shard_bytes(ileaves, list(ispecs.values()), sizes),
              "caches": caches}
    memory_port = {"params": _shard_bytes(pleaves, None, {}),
                   "moments": moments,
                   "inputs": _shard_bytes(ileaves, None, {}),
                   "caches": caches_whole}
    for terms in (memory, memory_port):
        terms["total"] = sum(terms[k] for k in MEMORY_TERMS)
    if shape.kind == "train":
        return memory, memory_port, params + moments
    logits = torch.empty((B, 1, cfg.vocab_padded), device=META)
    lspec = policy.batch_pspecs({"x": logits}, sizes, strategy=strategy)["x"]
    return memory, memory_port, (_shard_bytes(_numels([logits]), [lspec],
                                             sizes) + out_caches)


def lower_cell(arch_id, shape_id, *, multi_pod: bool = False,
               policy_name: str = "fp32_strict", num_microbatches: int = 1,
               fsdp: bool | None = None, strategy: str | None = None,
               moe_dispatch: str | None = None, routed_experts: int = 0,
               mesh=None, return_log: bool = False):
    """The record of one cell (see the module docstring).

    arch_id: a name of ``ARCH_IDS`` or an ``ArchConfig`` (a reduced one);
    shape_id: a name of ``SHAPES`` or a ``ShapeConfig`` (the card checks
    cut the batch so the cell fits one H100).  `mesh` (a ``{dim: size}``
    mapping or a DeviceMesh) replaces the production mesh.  `fsdp`
    defaults to `policy.needs_fsdp` against an H100's 80 GB.  With
    `return_log`, returns (record, the trace's dispatch log)."""
    cfg = get_arch(arch_id) if isinstance(arch_id, str) else arch_id
    if moe_dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    if routed_experts:
        cfg = dataclasses.replace(cfg, n_routed_experts=routed_experts)
    strategy = strategy or "tp"
    shape = SHAPES[shape_id] if isinstance(shape_id, str) else shape_id
    name, sizes = _mesh_of(multi_pod, mesh)
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": name,
               "status": "skipped", "reason": reason}
        return (rec, ()) if return_log else rec
    chips = math.prod(sizes.values())
    if fsdp is None:
        fsdp = policy.needs_fsdp(cfg, sizes, hbm_bytes=rl.HW["hbm_bytes"])
    record = {"arch": cfg.name, "shape": shape.name, "mesh": name,
              "mesh_shape": sizes, "chips": chips, "policy": policy_name,
              "fsdp": fsdp, "kind": shape.kind,
              "global_batch": shape.global_batch,
              "num_microbatches": num_microbatches, "strategy": strategy,
              "moe_dispatch": cfg.moe_dispatch}
    flops, log, seconds = _trace(cfg, shape, policy_name, num_microbatches)
    record["t_lower_s"] = round(seconds, 1)

    memory, memory_port, out_bytes = memory_terms(
        cfg, shape, sizes, fsdp=fsdp, strategy=strategy,
        policy_name=policy_name)
    record["memory"] = memory
    record["memory_port"] = memory_port
    record["fits"] = memory_port["total"] <= rl.HW["hbm_bytes"]
    zspecs = policy.zero1_pspecs(cfg, sizes, strategy=strategy)
    extra = (opt.zero1_collectives(cfg, zspecs, sizes)
             if shape.kind == "train" else ())
    pred = sharded.predict(log, sizes, strategy, extra=extra)
    record["collectives"] = {**pred["collectives"],
                             "zero1_gathers": len(extra),
                             "link_bytes": pred["link_bytes"]}
    record["paths"] = {p: n for p, n in pred["paths"].items() if n}
    record["dispatches"] = len(log)
    total, active = tfm.param_counts(cfg)
    roof = rl.Roofline(
        flops_per_chip=flops / chips, bytes_per_chip=float(
            memory["total"] + out_bytes),
        coll_bytes_per_chip=float(pred["link_bytes"]),
        dtype="fp32" if policy_name == "fp32_strict" else "bf16",
        chips=chips, model_flops=rl.model_flops_for(cfg, shape, total,
                                                    active))
    record["flops_total"] = flops
    record["flops_per_chip"] = flops / chips
    record["roofline"] = roof.to_dict()
    record["params_total"] = total
    record["params_active"] = active
    record["status"] = "ok"
    return (record, log) if return_log else record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="fp32_strict",
                    choices=["fp32_strict", "mixed"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--strategy", default=None, choices=[None, "tp", "fsdp"])
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "ep_scatter", "local"])
    ap.add_argument("--routed-experts", type=int, default=0,
                    help="override n_routed_experts")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = args.tag or args.policy
                name = (f"{arch}__{shape}__"
                        f"{'multi' if mp else 'single'}__{tag}.json")
                path = os.path.join(args.out, name)
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] skip (exists): {name}")
                    continue
                print(f"[dryrun] {arch} x {shape} x "
                      f"{'multi_pod(2,16,16)' if mp else 'single_pod(16,16)'}"
                      f" [{args.policy}]", flush=True)
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp,
                                     policy_name=args.policy,
                                     num_microbatches=args.microbatches,
                                     fsdp=fsdp, strategy=args.strategy,
                                     moe_dispatch=args.moe_dispatch,
                                     routed_experts=args.routed_experts)
                except Exception as e:  # a cell's boundary: record, go on
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi_pod" if mp else "single_pod",
                           "status": "error", "error": str(e)[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun]   ERROR: {str(e)[:300]}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[dryrun]   ok: trace={rec['t_lower_s']}s "
                          f"flops/chip={r['flops_per_chip']:.3e} "
                          f"dom={r['dominant']} "
                          f"useful={r['useful_ratio']:.2f} "
                          f"port_gb={rec['memory_port']['total'] / 1e9:.2f} "
                          f"fits={rec['fits']}", flush=True)
    print(f"[dryrun] done, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
