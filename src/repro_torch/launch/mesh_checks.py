"""What each rank runs in the checks of the sharded backend: the sharded
ops against their local launches, the LM engines under a mesh, and
training under a mesh.

`launch.mesh.spawn` runs `check_ops`, `serve_streams` and `train_check`
on every rank of a mesh, for the CPU tests (tests/test_torch_sharded.py,
tests/test_torch_sharded_train.py) and for ``chip_smoke.py``'s phases
`check_sharded`, `sharded_serve` and `sharded_train` on the card.
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

import dataclasses
import hashlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import backends, make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm, ops, sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine
from repro_torch.sharding import hints, policy
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (cnn_loss_fn, make_cnn_train_step,
                                          make_train_step)
from repro_torch.tree import flatten, unflatten_like


def rank_device(device_type: str) -> torch.device:
    """The device of a rank: the card's device 0, or the CPU."""
    return torch.device("cuda", 0) if device_type == "cuda" else \
        torch.device("cpu")


def launch_counts() -> dict[str, int]:
    """The launch counts of the kernels the sharded paths run, forward
    and backward."""
    return {**gemm.launch_counts(), **fa.launch_counts(),
            "flash_decode": fd.launches}


def reset_counts() -> None:
    """Launch, dispatch, path, collective and staging counts to 0."""
    gemm.reset_launches()
    fa.reset_launches()
    fd.reset_launches()
    backends.reset_dispatch_counts()
    sharded.reset_collectives()


def _counters() -> dict:
    """The launches, sharded paths, collectives and dispatches since the
    counts were last set to 0."""
    return {"launches": {k: c for k, c in launch_counts().items() if c},
            "paths": {p: c for p, c in sharded.path_counts().items() if c},
            "collectives": sharded.collective_counts(),
            "dispatch": {f"{b}.{o}": c for (b, o), c in
                         backends.dispatch_counts().items()}}


def predicted(mesh, strategy: str, dev, extra=()) -> dict:
    """What `kernels.sharded.predict` reads off the dispatch log since the
    counts were last set to 0 (the paths and the collectives, staged on a
    card), with `extra` collectives besides (the ZeRO-1 gathers): the
    figures `_counters` must then show."""
    log = backends.dispatch_log()
    if len(log) != sum(backends.dispatch_counts().values()):
        raise RuntimeError("the dispatch log overflowed; no prediction")
    sizes = policy.mesh_sizes(mesh) if mesh is not None else {}
    pred = sharded.predict(log, sizes, strategy, staged=dev.type == "cuda",
                           extra=extra)
    return {"paths": {p: c for p, c in pred["paths"].items() if c},
            "collectives": pred["collectives"]}


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
    version's).

    A case with ``grad`` differentiates the sharded op with a cotangent
    drawn after its forward and reports per operand (``grads``) the
    sharded gradient against the local wrapper's autograd and its plain
    version's, and the collectives of forward and backward
    (``grad_collectives``); ``refused`` gives the message of a dispatch
    that the engine refuses under grad."""
    dev = rank_device(device_type)
    eng = make_engine("sharded_cuda", device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mesh_of = _meshes(device_type)
    out = []
    for case in cases:
        a = _operands(case, dev, gen)
        if case.get("grad"):
            a = {k: t if t is None or not t.is_floating_point()
                 else t.requires_grad_() for k, t in a.items()}
        mesh = mesh_of(case.get("mesh"))
        host = {k: None if t is None else
                t.detach().cpu().requires_grad_(t.requires_grad)
                for k, t in a.items()}
        backends.clear_tile_cache()
        reset_counts()
        with hints.use_mesh(mesh), hints.strategy(case.get("strategy",
                                                           "tp")):
            if case["op"] == "partial":
                got = _local(case, a)
            elif case.get("grad"):
                try:
                    got = _sharded(case, a, eng)
                except NotImplementedError as e:
                    out.append({"name": case["name"], "refused": str(e)})
                    continue
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
        if case.get("grad"):
            res["grads"], res["grad_collectives"] = _op_grads(
                case, a, host, (got, local, plain), mesh, gen)
        res.update(_compare(got.detach(), local.detach()))
        res.update({f"plain_{k}": v for k, v in
                    _compare(got.detach().cpu(), plain.detach()).items()})
        res["shape"] = list(got.shape)
        out.append(res)
    return out


def _op_grads(case, a, host, outs, mesh, gen):
    """The operands' gradients of a case under a cotangent drawn from
    `gen`: the sharded op's (under `mesh`) against the local wrapper's
    and the plain version's."""
    got, local, plain = outs
    names = [k for k, t in a.items() if t is not None and t.requires_grad]
    dy = torch.randn(got.shape, generator=gen, device=got.device)
    with hints.use_mesh(mesh), hints.strategy(case.get("strategy", "tp")):
        g_sh = torch.autograd.grad(got, [a[k] for k in names], dy)
        _synchronize(got.device)
        counts = sharded.collective_counts()
    g_lo = torch.autograd.grad(local, [a[k] for k in names], dy)
    g_pl = torch.autograd.grad(plain, [host[k] for k in names], dy.cpu())
    return {k: {**_compare(s, lo), **{f"plain_{m}": v for m, v in
                                     _compare(s.cpu(), pl).items()}}
            for k, s, lo, pl in zip(names, g_sh, g_lo, g_pl)}, counts


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
           "mesh": [list(t) for t in st["mesh"]], **_counters(),
           "predicted": predicted(mesh, run.get("strategy", "tp"), dev)}
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


# ------------------------------------------------------------- training ---

def digest(tensors) -> str:
    """A digest of the bits of `tensors` (a tensor, or a dict or list of
    them, in order), computed where they lie: equal bits give equal
    digests, so ranks compare results without moving them.  Per tensor
    two sums modulo 2**64 (so in any order) over its 32-bit words (8- or
    16-bit for narrower dtypes), one weighted by position, in pieces of
    2**24 words."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    sums = []
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        words = {4: torch.int32, 2: torch.int16}.get(t.element_size())
        w = t.view(words) if words else t.view(torch.uint8)
        a = b = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, w.numel(), 1 << 24):
            x = w[i:i + (1 << 24)].to(torch.int64)
            pos = torch.arange(i, i + x.numel(), device=x.device) % 65521 + 1
            a = a + x.sum()
            b = b + (x * pos).sum()
        sums.append(f"{tuple(t.shape)}:{int(a)}:{int(b)}")
    return hashlib.sha256(";".join(sums).encode()).hexdigest()


def relmax(got, want) -> float:
    """max |got - want| / (max |want| + 1e-12)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def worst(got: dict, want: dict) -> tuple[float, str]:
    """The largest `relmax` over the tensors of `want`, and its name."""
    errs = {k: relmax(got[k], w) for k, w in want.items()}
    name = max(errs, key=errs.get)
    return errs[name], name


def lm_value_and_grad(eng, cfg, params, batch, ce_chunk):
    """`transformer.loss_fn` (remat) and its gradient with respect to every
    parameter by flat name (0 for a parameter the loss does not read), as
    `make_train_step` takes them."""
    leaves = {k: p.detach().requires_grad_()
              for k, p in flatten(params).items()}
    loss = tfm.loss_fn(eng, cfg, unflatten_like(leaves, params), batch,
                       remat=True, ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def _memory(dev):
    """(allocated bytes now, a reader of the peak GB above it) on a card;
    on the CPU (0, a reader of None)."""
    if dev.type != "cuda":
        return 0, lambda: None
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return base, lambda: (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def _lm_cfg(model: dict):
    cfg = get_arch(model["arch"])
    if model.get("reduced"):
        cfg = reduced(cfg)
    if model.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=model["layers"])
    return cfg


def _lm_params(cfg, model: dict, dev):
    if model.get("params") is not None:
        return convert.lm_params_from_jax(model["params"], cfg, dev)
    return random_lm_params(cfg, dev, model["seed"])


def _lm_steps(eng, cfg, model, run, ocfg, batches, dev, mesh=None):
    """`run["steps"]` steps of `make_train_step` from fresh parameters
    under `mesh`, moments replicated or (``run["zero1"]``) ZeRO-1.
    Returns (report, {"params", "mu", "nu"} by flat name, moments
    gathered)."""
    params = _lm_params(cfg, model, dev)
    base, peak = _memory(dev)
    if run.get("zero1"):
        state = opt.zero1_init(flatten(params), policy.flat_specs(
            cfg, _zero1_specs(cfg, mesh, run)), mesh)
    else:
        state = opt.adamw_init(flatten(params))
    step = make_train_step(eng, cfg, ocfg, ce_chunk=model["ce_chunk"])
    moment_bytes = sum(t.numel() * t.element_size()
                       for key in ("mu", "nu") for t in state[key].values())
    metrics = []
    _synchronize(dev)
    t0 = time.perf_counter()
    for i, batch in enumerate(batches[:run["steps"]]):
        params, state, m = step(params, state, batch)
        metrics.append(m)
        if i + 1 == run.get("restore_at"):
            ckpt.save(run["ckpt_dir"], i + 1, (flatten(params), state))
    _synchronize(dev)
    wall = time.perf_counter() - t0
    moments = opt.gather_moments(state) if run.get("zero1") else state
    report = {"losses": [float(m["loss"]) for m in metrics],
              "grad_norms": [float(m["grad_norm"]) for m in metrics],
              "lrs": [float(m["lr"]) for m in metrics],
              "ms_per_step": wall / max(1, run["steps"]) * 1e3,
              "peak_gb": peak(), "moment_gb": moment_bytes / 1e9,
              "moment_bytes": moment_bytes,
              "base_gb": base / 1e9}
    flat = flatten(params)
    return report, {"params": flat, **{key: {k: moments[key][k] for k in flat}
                                       for key in ("mu", "nu")}}


def _lm_resume(eng, cfg, model, run, ocfg, batches, dev, mesh,
               got: dict) -> dict:
    """A ZeRO-1 run's checkpoint (saved after step ``restore_at``, its
    moments whole), restored with ``shardings=`` (this rank's ZeRO-1
    blocks, cut on the host) and without (the moments replicated on the
    device), each stepped to the run's end: whether each equals the
    uninterrupted run (`got`) bit for bit.  The restore's templates are
    empty tensors (`restore` reads only their device and dtype), so the
    run's memory grows by the restored tree alone."""
    k = run["restore_at"]
    names = list(got["params"])

    def empty(device):
        return {n: torch.empty(0, dtype=got["params"][n].dtype,
                               device=device) for n in names}

    layout = opt.zero1_init(got["params"], policy.flat_specs(
        cfg, _zero1_specs(cfg, mesh, run)), mesh)
    skeleton = tfm.init_params(cfg, generator=None, device="meta")
    step = make_train_step(eng, cfg, ocfg, ce_chunk=model["ce_chunk"])
    out = {}
    for name, moments, shardings in (
            ("zero1", "cpu", (None, layout)), ("replicated", dev, None)):
        like = (empty(dev), {"mu": empty(moments), "nu": empty(moments),
                             "step": 0})
        (pflat, state), _ = ckpt.restore(run["ckpt_dir"], k, like,
                                         shardings=shardings)
        p = unflatten_like(pflat, skeleton)
        for batch in batches[k:run["steps"]]:
            p, state, _ = step(p, state, batch)
        whole = opt.gather_moments(state) if "zero1" in state else state
        pf = flatten(p)
        out[f"{name}_bitwise"] = _same(
            {"params": pf, **{key: {n: whole[key][n] for n in pf}
                              for key in ("mu", "nu")}},
            {key: got[key] for key in ("params", "mu", "nu")})
        out[f"{name}_step"] = state["step"]
        del p, pf, pflat, state, whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _zero1_specs(cfg, mesh, run: dict):
    """The moment specs of a ZeRO-1 run: `zero1_pspecs` at the run's
    strategy, or with ``zero1="layers"`` 'data' on every stack's layer
    dim (`_by_layer`)."""
    specs = policy.zero1_pspecs(cfg, mesh, run.get("strategy", "tp"))
    if run["zero1"] == "layers":
        specs = {**specs, "stacks": [_by_layer(t) for t in specs["stacks"]]}
    return specs


def _lm_predicted(cfg, run: dict, mesh, dev) -> dict:
    """`predicted` for an LM run: a ZeRO-1 run's steps each gather every
    leaf's new parameter block, and `gather_moments` then its mu and nu
    blocks (the same gathers)."""
    extra = ()
    if run.get("zero1"):
        # each step, gather_moments' mu and nu, and a checkpoint's mu and
        # nu when the run saves one
        extra = opt.zero1_collectives(cfg, _zero1_specs(cfg, mesh, run),
                                      mesh) * (run["steps"] + 2 + (
                                          2 if run.get("restore_at") else 0))
    return predicted(mesh, run.get("strategy", "tp"), dev, extra)


def _by_layer(stack: dict) -> dict:
    """A stack's specs with 'data' on the layer dim alone: each rank holds
    the moments of whole layers (what ``strategy="fsdp"`` gives a leaf
    whose layer dim is its largest, such as mamba2-1.3b's conv_x)."""
    return {k: _by_layer(v) if isinstance(v, dict)
            else ("data",) + (None,) * (len(v) - 1) for k, v in stack.items()}


def _lm_grad(eng, cfg, model, batch, dev):
    params = _lm_params(cfg, model, dev)
    base, peak = _memory(dev)
    t0 = time.perf_counter()
    loss, grads = lm_value_and_grad(eng, cfg, params, batch,
                                    model["ce_chunk"])
    _synchronize(dev)
    return ({"losses": [float(loss)],
             "ms_per_step": (time.perf_counter() - t0) * 1e3,
             "peak_gb": peak(), "base_gb": base / 1e9},
            {"loss": loss, "grads": grads})


def _lm_arrays(cfg, got: dict) -> dict:
    """A run's tensors as numpy trees in the JAX layout (the CPU tests)."""
    skeleton = tfm.init_params(cfg, generator=None, device="meta")
    return {key: float(flat) if key == "loss" else
            convert.lm_params_to_numpy(unflatten_like(flat, skeleton), cfg)
            for key, flat in got.items()}


def _same(a: dict, b: dict) -> bool:
    """Whether two runs' tensors (loss, or dicts by name) have equal bits."""
    for key, x in a.items():
        y = b[key]
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif set(x) != set(y) or not all(torch.equal(t, y[k])
                                         for k, t in x.items()):
            return False
    return True


def _report(run, mesh, wall, counts, got) -> dict:
    return {"name": run["name"], "mesh": [list(t) for t in
                                         hints.mesh_topology(mesh)],
            "strategy": run.get("strategy", "tp"), "wall_s": wall, **counts,
            "digest": {k: digest(v) for k, v in got.items()}}


def _lm_reference(ref, floor, cfg, model, run, ocfg, batches, dev, got,
                  losses):
    """Rank 0's one-process run on `ref` (and, for steps, `floor`, the
    second correct fp32 program) of what a sharded run computed (`got`,
    its tensors, and `losses`): the errors of the sharded run against
    `ref` and of `floor` against `ref`."""
    if not run.get("steps"):
        rep, want = _lm_grad(ref, cfg, model, batches[0], dev)
        loss, w = float(got["loss"]), float(want["loss"])
        err, name = worst(got["grads"], want["grads"])
        return {"ms_per_step": rep["ms_per_step"], "peak_gb": rep["peak_gb"],
                "loss": w, "loss_rel_err": abs(loss - w) / abs(w),
                "grad_relmax": err, "grad_worst": name,
                "grad_max_abs_err": max(float((g - want["grads"][k]).abs()
                                              .max())
                                        for k, g in got["grads"].items())}
    plain = {"steps": run["steps"]}
    rep, want = _lm_steps(ref, cfg, model, plain, ocfg, batches, dev)
    frep, fgot = _lm_steps(floor, cfg, model, plain, ocfg, batches, dev)
    out = {"ms_per_step": rep["ms_per_step"], "peak_gb": rep["peak_gb"],
           "losses": rep["losses"], "floor_losses": frep["losses"],
           "loss_rel_err": [abs(a - w) / abs(w) for a, w in
                            zip(losses, rep["losses"])],
           "loss_rel_floor": [abs(f - w) / abs(w) for f, w in
                              zip(frep["losses"], rep["losses"])]}
    for key in ("params", "mu", "nu"):
        out[f"{key}_relmax"], out[f"{key}_worst"] = worst(got[key],
                                                          want[key])
        out[f"{key}_floor"], _ = worst(fgot[key], want[key])
    return out


def _lm_train(model: dict, spec: dict, eng, mesh_of, dev) -> dict:
    """Every run of one LM config (see `train_check`)."""
    cfg = _lm_cfg(model)
    ocfg = opt.AdamWConfig(**spec["ocfg"])
    b, s = model["batch"]
    data = SyntheticLM(cfg, ShapeConfig("train", s, b, "train"),
                       seed=model["data_seed"])
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(max([1] + [r.get("steps", 0)
                                         for r in model["runs"]]))]
    runs, kept = [], {}
    for run in model["runs"]:
        mesh = mesh_of(run["mesh"])
        _synchronize(dev)
        reset_counts()
        t0 = time.perf_counter()
        with hints.use_mesh(mesh), hints.strategy(run.get("strategy", "tp")):
            if run.get("steps"):
                rep, got = _lm_steps(eng, cfg, model, run, ocfg, batches,
                                     dev, mesh)
            else:
                rep, got = _lm_grad(eng, cfg, model, batches[0], dev)
            _synchronize(dev)
            wall = time.perf_counter() - t0
            counts = _counters()
            counts["predicted"] = _lm_predicted(cfg, run, mesh, dev)
            if run.get("rerun"):
                rep["rerun_bitwise"] = _same(got, _lm_grad(
                    eng, cfg, model, batches[0], dev)[1])
            if run.get("restore_at"):
                rep["restored"] = _lm_resume(eng, cfg, model, run, ocfg,
                                             batches, dev, mesh, got)
        rep.update(_report(run, mesh, wall, counts, got))
        if run.get("same_as"):
            rep["bitwise_same_as"] = _same(got, kept[run["same_as"]])
        if spec.get("arrays"):
            rep["arrays"] = _lm_arrays(cfg, got)
        runs.append(rep)
        kept[run["name"]] = got
    if spec.get("reference") and dist.get_rank() == 0:
        ref = make_engine(spec["reference"], device=dev)
        floor = make_engine(spec["floor"], device=dev)
        for run, rep in zip(model["runs"], runs):
            if not run.get("same_as"):
                rep["reference"] = _lm_reference(
                    ref, floor, cfg, model, run, ocfg, batches, dev,
                    kept[run["name"]], rep["losses"])
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [b, s],
            "runs": runs}


def _cnn_net(model: dict, eng):
    net = Network(model["cfg"], eng, generator=torch.Generator().manual_seed(
        model.get("seed", 0)))
    if model.get("params") is not None:
        net.load_state_dict(convert.params_from_jax(model["params"]))
        return net
    gen = torch.Generator().manual_seed(model["seed"] + 1)
    with torch.no_grad():       # BN statistics away from 1 / 0
        for name, p in net.named_parameters():
            if name.endswith((".gamma", ".var")):
                p.copy_(torch.rand(p.shape[0], generator=gen) + 0.5)
            elif name.endswith((".beta", ".mean")):
                p.copy_(torch.randn(p.shape[0], generator=gen) * 0.1)
    return net


def _cnn_step(eng, model, ocfg, batch, dev) -> tuple[dict, dict]:
    """Loss and gradients of `cnn_loss_fn`, then one `make_cnn_train_step`
    step, on a fresh network."""
    net = _cnn_net(model, eng)
    params = dict(net.named_parameters())
    base, peak = _memory(dev)
    t0 = time.perf_counter()
    loss = cnn_loss_fn(net, *batch)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    state = opt.adamw_init(params)
    state, m = make_cnn_train_step(net, ocfg)(state, batch)
    _synchronize(dev)
    rep = {"losses": [float(loss.detach()), float(m["loss"])],
           "grad_norms": [float(m["grad_norm"])],
           "ms_per_step": (time.perf_counter() - t0) * 1e3,
           "peak_gb": peak(), "base_gb": base / 1e9}
    return rep, {"loss": loss.detach(), "grads": grads,
                 "params": {k: p.detach() for k, p in params.items()},
                 "mu": state["mu"], "nu": state["nu"]}


def _cnn_train(model: dict, spec: dict, eng, mesh_of, dev) -> dict:
    """Every run of one Darknet cfg (see `train_check`)."""
    ocfg = opt.AdamWConfig(**spec["ocfg"])
    if model.get("images") is not None:
        images, labels = model["images"], model["labels"]
    else:
        net = Network(model["cfg"], make_engine("eager", device="cpu"))
        rng = np.random.default_rng(model["data_seed"])
        images = rng.standard_normal((model["batch"], *net.in_shape)
                                     ).astype(np.float32)
        labels = rng.integers(0, net.out_shape[-1], model["batch"])
    batch = (torch.from_numpy(images).to(dev),
             torch.from_numpy(np.asarray(labels, np.int64)).to(dev))
    runs = []
    for run in model["runs"]:
        mesh = mesh_of(run["mesh"])
        _synchronize(dev)
        reset_counts()
        t0 = time.perf_counter()
        with hints.use_mesh(mesh), hints.strategy(run.get("strategy", "tp")):
            rep, got = _cnn_step(eng, model, ocfg, batch, dev)
            wall = time.perf_counter() - t0
            counts = _counters()
            counts["predicted"] = predicted(mesh, run.get("strategy", "tp"),
                                            dev)
        rep.update(_report(run, mesh, wall, counts, got))
        if spec.get("arrays"):
            rep["arrays"] = {k: float(v) if k == "loss" else
                             convert.params_to_numpy(v)
                             for k, v in got.items()}
        if spec.get("reference") and dist.get_rank() == 0:
            ref, want = _cnn_step(make_engine(spec["reference"], device=dev),
                                  model, ocfg, batch, dev)
            _, fgot = _cnn_step(make_engine(spec["floor"], device=dev),
                                model, ocfg, batch, dev)
            loss, w = float(got["loss"]), float(want["loss"])
            rep["reference"] = {"ms_per_step": ref["ms_per_step"],
                                "loss": w, "loss_rel_err": abs(loss - w)
                                / abs(w)}
            err, name = worst(got["grads"], want["grads"])
            rep["reference"].update(grad_relmax=err, grad_worst=name)
            for key in ("params", "mu", "nu"):
                err, name = worst(got[key], want[key])
                rep["reference"].update({f"{key}_relmax": err,
                                         f"{key}_worst": name,
                                         f"{key}_floor": worst(
                                             fgot[key], want[key])[0]})
        runs.append(rep)
    return {"cfg": model.get("name", "cnn"), "batch": model["batch"],
            "runs": runs}


def train_check(device_type: str, spec: dict) -> dict:
    """Training under meshes on this rank.

    `spec`: ``ocfg`` (`AdamWConfig` fields), ``lm`` and ``cnn``, lists of
    models, ``ops`` (`check_ops` cases, drawn from ``ops_seed``, run
    first), and optionally ``arrays`` (return every run's tensors as numpy
    trees: the CPU tests hold them against the JAX package) and
    ``reference`` / ``floor`` (backend names: rank 0 then repeats each run
    in one process on `reference`, and a trajectory also on `floor`, the
    second correct fp32 program, and reports the errors).

    An LM model: ``arch``, ``reduced``, ``layers`` (a cut depth, or
    None), ``params`` (a JAX tree of numpy arrays, carried by `convert`)
    or ``seed`` (`random_lm_params`), ``batch`` (B, S), ``data_seed``
    (`SyntheticLM`'s), ``ce_chunk`` and ``runs``, each ``{name, mesh:
    (shape, dims), strategy}`` and either ``steps`` (that many
    `make_train_step` steps from fresh parameters; ``zero1``: the moments
    by `optimizer.zero1_init` under `zero1_pspecs` at the run's strategy,
    or with ``"layers"`` under 'data' on every stack's layer dim
    (`_by_layer`); ``same_as``: a run whose parameters and
    gathered moments it must equal bit for bit; with ``zero1``,
    ``restore_at`` and ``ckpt_dir``: save a checkpoint after that step,
    then restore it with and without ``shardings=`` and step each to the
    end, `_lm_resume`) or none (one
    `lm_value_and_grad`; ``rerun``: again, bit for bit).  A Darknet
    model: ``cfg`` (its text), ``name``, ``params`` (a JAX tree) or
    ``seed``, ``batch``, ``images`` / ``labels`` (numpy) or
    ``data_seed``, and ``runs`` ({name, mesh}): each the loss and
    gradients of `cnn_loss_fn`, then one `make_cnn_train_step` step.

    Every run starts from fresh parameters with every count set to 0 and
    reports the losses, ms per step, peak GB above what was allocated
    before (on a card), launches, paths, collectives, dispatches and a
    `digest` of each result.  Returns ``{rank, ops, lm, cnn}``."""
    dev = rank_device(device_type)
    eng = make_engine("sharded_cuda", device=dev)
    mesh_of = _meshes(device_type)
    out = {"rank": dist.get_rank(),
           "ops": check_ops(device_type, spec.get("ops", []),
                            spec.get("ops_seed", 0)),
           "lm": [_lm_train(m, spec, eng, mesh_of, dev)
                  for m in spec.get("lm", [])],
           "cnn": [_cnn_train(m, spec, eng, mesh_of, dev)
                   for m in spec.get("cnn", [])]}
    dist.barrier()
    return out


def collective_check(device_type: str, spec: dict) -> dict:
    """The paths and collectives `kernels.sharded.predict` reads off each
    run's dispatch log beside the counts the run made, on this rank.

    `spec`: ``arch``, ``reduced`` and ``seed`` (the LM, `random_lm_params`),
    ``serve`` (runs of `serve_streams`' form), ``lm`` and ``cnn`` (models
    of `train_check`'s form, with ``ocfg``).  Returns ``{rank, serve, lm,
    cnn}``:
    every run's report, each with ``paths``, ``collectives`` and
    ``predicted``."""
    dev = rank_device(device_type)
    cfg = get_arch(spec["arch"])
    if spec.get("reduced"):
        cfg = reduced(cfg)
    params = random_lm_params(cfg, dev, spec["seed"])
    eng = make_engine("sharded_cuda", device=dev)
    mesh_of = _meshes(device_type)
    out = {"rank": dist.get_rank(),
           "serve": [_serve(cfg, params, eng, run, mesh_of(run["mesh"]))
                     for run in spec.get("serve", [])],
           "lm": [_lm_train(m, spec, eng, mesh_of, dev)
                  for m in spec.get("lm", [])],
           "cnn": [_cnn_train(m, spec, eng, mesh_of, dev)
                   for m in spec.get("cnn", [])]}
    dist.barrier()
    return out
