"""What each rank runs in the checks of the sharded backend: the sharded
ops against their local launches, and the LM engines under a mesh.

`launch.mesh.spawn` runs `check_ops` and `serve_streams` on every rank of
a mesh, for the CPU tests (tests/test_torch_sharded.py) and for
``chip_smoke.py``'s phases `check_sharded` and `sharded_serve` on the card.
They live in the port, so a rank imports neither the tests nor the JAX
package.  Every rank draws its operands from a generator of its own seed on
its device, so all ranks hold the same operands, replicated as the design
of kernels/sharded.py has them; results come back as host data.

A case of `check_ops` is a dict: ``op`` (``matmul``, ``bmm``, ``conv2d``,
``attention``, ``partial``), its sizes, ``mesh`` (``(shape, dims)`` or
None) and ``strategy`` ("tp" by default).  Each case runs the sharded op
through ``make_engine("sharded_cuda")`` under the mesh, the local wrapper
the `cuda` backend calls (`kernels/ops.py`) on the same operands, and that
wrapper on host copies (its plain version), and reports how they compare.
"""
from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import backends, make_engine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm, ops, sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine
from repro_torch.sharding import hints
from repro_torch.tree import flatten


def rank_device(device_type: str) -> torch.device:
    """The device of a rank: the card's device 0, or the CPU."""
    return torch.device("cuda", 0) if device_type == "cuda" else \
        torch.device("cpu")


def launch_counts() -> dict[str, int]:
    """The launch counts of the kernels the sharded paths run."""
    return {**gemm.launch_counts(), **fa.launch_counts(),
            "flash_decode": fd.launches}


def reset_counts() -> None:
    """Launch, dispatch, path, collective and staging counts to 0."""
    gemm.reset_launches()
    fa.reset_launches()
    fd.reset_launches()
    backends.reset_dispatch_counts()
    sharded.reset_collectives()


def _synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compare(got, want) -> dict:
    """bitwise, max |got - want| and that over max |want|."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    peak = float(want.float().abs().max()) if want.numel() else 0.0
    return {"bitwise": bool(torch.equal(got, want)), "max_abs_err": err,
            "relmax": err / (peak + 1e-12)}


def _meshes(device_type: str):
    """A get-or-make of meshes by (shape, dims) (None: off-mesh)."""
    made = {}

    def get(spec):
        if spec is None:
            return None
        key = (tuple(spec[0]), tuple(spec[1]))
        if key not in made:
            made[key] = mesh_lib.make_mesh(*key, device_type=device_type)
        return made[key]

    return get


def _operands(case: dict, dev, gen) -> dict:
    """The case's operands, fp32, drawn from `gen` on `dev`."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    op = case["op"]
    if op == "matmul":
        m, k, n = case["m"], case["k"], case["n"]
        w = rnd(n, k).t() if case.get("trans") else rnd(k, n)
        return {"x": rnd(m, k), "w": w / k ** 0.5,
                "scale": rnd(n) if case.get("scale") else None,
                "shift": rnd(n) if case.get("shift") else None}
    if op == "bmm":
        b, m, k, n = case["b"], case["m"], case["k"], case["n"]
        return {"x": rnd(b, m, k), "w": rnd(b, k, n) / k ** 0.5}
    if op == "conv2d":
        b, h, w, c, n = (case[key] for key in ("b", "h", "w", "cin", "cout"))
        kdim = case["size"] ** 2 * c
        return {"x": rnd(b, h, w, c), "w": rnd(kdim, n) / kdim ** 0.5,
                "scale": rnd(n) if case.get("scale") else None,
                "shift": rnd(n) if case.get("shift") else None}
    b, sq, skv, h, kv, d = (case[key] for key in ("b", "sq", "skv", "h",
                                                  "kv", "d"))
    lens = case.get("kv_len")
    return {"q": rnd(b, sq, h, d), "k": rnd(b, skv, kv, d),
            "v": rnd(b, skv, kv, d),
            "kv_len": None if lens is None else torch.tensor(
                lens, dtype=torch.int32, device=dev)}


def _local(case: dict, a: dict):
    """The local computation of a case: the wrapper the `cuda` backend
    calls (on CPU tensors, its plain version)."""
    op = case["op"]
    if op == "matmul":
        return ops.matmul(a["x"], a["w"], a["scale"], a["shift"],
                          act=case.get("act", "linear"))
    if op == "bmm":
        return ops.bmm(a["x"], a["w"])
    if op == "conv2d":
        def mm(x, w, scale, shift, *, act, out_dtype, ctx):
            return ops.matmul(x, w, scale, shift, act=act,
                              out_dtype=out_dtype)

        return backends.im2col_conv2d(mm)(
            a["x"], a["w"], a["scale"], a["shift"], size=case["size"],
            stride=case.get("stride", 1), pad=case.get("pad", 0),
            act=case.get("act", "linear"), out_dtype=a["x"].dtype, ctx=None)
    if op == "partial":
        o, lse = ops.attention_partial(a["q"], a["k"], a["v"], a["kv_len"],
                                       causal=case.get("causal", True))
        return torch.cat([o.float(), lse[..., None]], dim=-1)
    return sharded._local_attention(a["q"], a["k"], a["v"], a["kv_len"],
                                    None, causal=case.get("causal", True))


def _sharded(case: dict, a: dict, eng):
    op = case["op"]
    if op == "matmul":
        return eng.matmul(a["x"], a["w"], scale=a["scale"], shift=a["shift"],
                          act=case.get("act", "linear"))
    if op == "bmm":
        return eng.bmm(a["x"], a["w"])
    if op == "conv2d":
        return eng.conv2d(a["x"], a["w"], scale=a["scale"], shift=a["shift"],
                          size=case["size"], stride=case.get("stride", 1),
                          pad=case.get("pad", 0),
                          act=case.get("act", "linear"))
    return eng.attention(a["q"], a["k"], a["v"],
                         causal=case.get("causal", True), kv_len=a["kv_len"])


def _span_loop(case: dict, a: dict, n: int):
    """The sequence split in one process: every span's partial
    (`ops.attention_partial` at its relative extent) merged by
    `flash_decode.combine`, as the ranks do it together."""
    q, k, v, kvl = a["q"], a["k"], a["v"], a["kv_len"]
    b, skv = q.shape[0], k.shape[1]
    span = skv // n
    if kvl is None:
        kvl = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    qs = ops.scale_queries(q)
    parts = [ops.attention_partial(
        qs, k[:, s * span:(s + 1) * span], v[:, s * span:(s + 1) * span],
        kvl - s * span, 1.0, causal=case.get("causal", True))
        for s in range(n)]
    o = torch.stack([p[0].float() for p in parts])
    lse = torch.stack([p[1] for p in parts])
    out = fd.combine(o.movedim(0, 2), lse.movedim(0, 2))
    return out.transpose(1, 2).to(q.dtype)


def check_ops(device_type: str, cases: list, seed: int) -> list[dict]:
    """Every case of `cases` on this rank (see the module docstring).
    Returns per case: the sharded path taken, the sharded result against
    the local launch (``bitwise``, ``max_abs_err``, ``relmax``) and
    against the plain version (``plain_*``), the per-shard plan keys the
    wrappers resolved (``keys``, the autotune cache's key strings), the
    launches and collectives of the sharded call; for a seq-split case
    ``loop_bitwise`` (against `_span_loop`), for a ``partial`` case
    ``sentinel_exact`` (the empty rows' lse equal to the plain
    version's)."""
    dev = rank_device(device_type)
    eng = make_engine("sharded_cuda", device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mesh_of = _meshes(device_type)
    out = []
    for case in cases:
        a = _operands(case, dev, gen)
        mesh = mesh_of(case.get("mesh"))
        host = {k: None if t is None else t.cpu() for k, t in a.items()}
        backends.clear_tile_cache()
        reset_counts()
        with hints.use_mesh(mesh), hints.strategy(case.get("strategy",
                                                           "tp")):
            if case["op"] == "partial":
                got = _local(case, a)
            else:
                got = _sharded(case, a, eng)
            _synchronize(dev)
            paths = {p: c for p, c in sharded.path_counts().items() if c}
            res = {"name": case["name"], "op": case["op"],
                   "paths": paths, "launches": {
                       k: c for k, c in launch_counts().items() if c},
                   "collectives": sharded.collective_counts(),
                   "keys": sorted(backends.autotune_report())}
            if "attention_seq" in paths:
                res["loop_bitwise"] = bool(torch.equal(
                    got, _span_loop(case, a, mesh.size())))
        local = _local(case, a)
        plain = _local(case, host)
        if case["op"] == "partial":
            # the rows with no live key hold the -1e30 sentinel in lse
            # (and o 0): held apart, exactly, and out of the error
            dead = got[..., -1].cpu() == fd.EMPTY_SPAN_LSE
            res["sentinel_rows"] = int(dead.sum())
            res["sentinel_exact"] = bool(torch.equal(
                dead, plain[..., -1] == fd.EMPTY_SPAN_LSE) and torch.equal(
                got.cpu()[dead], plain[dead]))
            got, local, plain = (t.masked_fill(dead.to(t.device)[..., None],
                                               0.0)
                                 for t in (got, local, plain))
        res.update(_compare(got, local))
        res.update({f"plain_{k}": v for k, v in
                    _compare(got.cpu(), plain).items()})
        res["shape"] = list(got.shape)
        out.append(res)
    return out


def random_lm_params(cfg, dev, seed: int = 4) -> dict:
    """Full-width random LM parameters from a seed on `dev`, with random
    QKV biases (the init's zeros would leave the bias epilogue untested):
    the parameters of ``chip_smoke.py``'s LM phases."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, device=dev)
    with torch.no_grad():
        for lp in params["layers"]:
            for name in ("bq", "bk", "bv"):
                b = lp["attn"][name]
                b.copy_(torch.randn(b.shape, generator=gen, device=dev) * 0.1)
    return params


def _checksum(params) -> float:
    return float(sum(t.double().sum() for t in flatten(params).values()))


def _requests(spec) -> list[Request]:
    return [Request(rid=i, prompt=list(p), max_new=n)
            for i, (p, n) in enumerate(spec)]


def _serve(cfg, params, eng, run: dict, mesh) -> dict:
    """One run of a slot or paged engine over `run["requests"]` under
    `mesh` (None: unsharded), counts set to 0 just before."""
    dev = eng.device
    cls = PagedServingEngine if run["engine"] == "paged" else ServingEngine
    server = cls(cfg, params, engine=eng, mesh=mesh, **run["kwargs"])
    reqs = _requests(run["requests"])
    _synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    with hints.strategy(run.get("strategy", "tp")):
        server.run(reqs)
    _synchronize(dev)
    wall = time.perf_counter() - t0
    st = server.stats()
    out = {"name": run["name"], "streams": [r.out for r in reqs],
           "done": all(r.done for r in reqs), "steps": st["steps"],
           "wall_s": wall, "ms_per_step": wall / max(1, st["steps"]) * 1e3,
           "mesh": [list(t) for t in st["mesh"]],
           "launches": {k: c for k, c in launch_counts().items() if c},
           "paths": {p: c for p, c in sharded.path_counts().items() if c},
           "collectives": sharded.collective_counts(),
           "dispatch": {f"{b}.{o}": c
                        for (b, o), c in backends.dispatch_counts().items()}}
    if run["engine"] == "paged":
        out["compile_keys"] = sorted(
            json.dumps(k) for k in st["compile"]["dispatches"])
    return out


def _margin(cfg, params, eng, tokens: list) -> float:
    """Top-2 logit margin after `tokens` under `eng` (a near tie is a
    small one)."""
    with torch.inference_mode():
        h, _ = tfm.forward_hidden(eng, cfg, params, tokens=torch.tensor(
            [tokens], device=eng.device))
        top2 = torch.topk(h[0, -1] @ tfm.head_weight(params, cfg), 2).values
    return float(top2[0] - top2[1])


def serve_streams(device_type: str, spec: dict) -> dict:
    """The LM engines under meshes on this rank.

    `spec`: ``arch`` and ``reduced`` (the config), ``params`` (a JAX
    parameter tree of numpy arrays, carried by `convert`) or ``seed``
    (`random_lm_params`), and ``runs``, each ``{name, engine: "slot" |
    "paged", mesh: (shape, dims), strategy, kwargs, requests: [(prompt,
    max_new), ...]}``.  With ``reference`` (a backend name, `cuda` on the
    card) rank 0 also serves each run unsharded on that backend and, where
    a stream differs, reports the top-2 margin there at the first
    differing token.

    Returns ``{rank, checksums (every rank's parameter checksum), runs,
    reference}``."""
    dev = rank_device(device_type)
    cfg = get_arch(spec["arch"])
    if spec.get("reduced"):
        cfg = reduced(cfg)
    if spec.get("params") is not None:
        params = convert.lm_params_from_jax(spec["params"], cfg, dev)
    else:
        params = random_lm_params(cfg, dev, spec["seed"])
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, _checksum(params))
    eng = make_engine("sharded_cuda", device=dev)
    mesh_of = _meshes(device_type)
    runs = [_serve(cfg, params, eng, run, mesh_of(run["mesh"]))
            for run in spec["runs"]]
    out = {"rank": dist.get_rank(), "checksums": sums, "runs": runs,
           "reference": []}
    if spec.get("reference") and dist.get_rank() == 0:
        ref_eng = make_engine(spec["reference"], device=dev)
        for run, got in zip(spec["runs"], runs):
            ref = _serve(cfg, params, ref_eng, run, None)
            ref["mismatches"] = []
            for (prompt, _), a, b in zip(run["requests"], got["streams"],
                                         ref["streams"]):
                if a == b:
                    continue
                j = next((i for i, (x, y) in enumerate(zip(a, b))
                          if x != y), min(len(a), len(b)))
                ref["mismatches"].append({
                    "token": j, "margin": _margin(
                        cfg, params, ref_eng, list(prompt) + b[:j])})
            out["reference"].append(ref)
    dist.barrier()
    return out
