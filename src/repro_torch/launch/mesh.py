"""Device meshes, the ranks that serve on them, and the one transport their
collectives take (PyTorch port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over an initialised process group (functions only: importing this module
touches no device and no process group).  `spawn` starts the ranks of
one: each runs in a process of its own, started with the ``spawn`` method,
and joins a gloo process group through a file store, so concurrent test
workers never race for a port.  On the card every rank takes device 0:
one H100 holds every rank (NCCL refuses two ranks on one device).

The transport is gloo's all-gather on host tensors, on the CPU and on the
card alike.  A CUDA operand is staged through host memory explicitly: one
copy to the host before the collective and one back after it, each
counted in `staged_transfers` (with its bytes), so a run can report what
the staging cost.
"""
from __future__ import annotations

import collections
import math
import os
import queue
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding import hints

# The production meshes of the JAX launcher: 16 x 16 chips a pod, and two
# pods with a leading pod dim.
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

_STAGED = collections.Counter()


def make_mesh(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A mesh of `shape` with dims named `axes` over the initialised
    process group (elastic restarts, tests).  Raises ValueError when the
    names do not match the shape or the group's world size is not the
    mesh's size, RuntimeError when no process group is initialised."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} needs as many distinct dim "
                         f"names, got {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(launch.mesh.spawn starts one per rank)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh over {axes} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh of 256 ranks; `multi_pod` adds a
    leading "pod" dim (512).  Raises ValueError naming both when the
    process group's world size differs."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"make_production_mesh(multi_pod={multi_pod}) "
                         f"needs {math.prod(shape)} ranks ({shape} over "
                         f"{axes}); this process has {world}")
    return make_mesh(shape, axes, device_type=device_type)


def set_mesh(mesh):
    """Context manager installing `mesh` (`sharding.hints.use_mesh`)."""
    return hints.use_mesh(mesh)


def dp_size(mesh) -> int:
    """Ranks along the data-parallel dims ("pod", "data") of `mesh`."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


# ---------------------------------------------------------------- transport

def gather(t: torch.Tensor, group) -> torch.Tensor:
    """All-gather `t` over the ranks of `group`: returns (n, *t.shape) on
    t's device, rank i's tensor at index i.  gloo on host tensors; a CUDA
    `t` is copied to the host and the result back to the card, both
    counted in `staged_transfers`."""
    n = dist.get_world_size(group)
    host = t.contiguous()
    if host.device.type != "cpu":
        host = host.cpu()
        _STAGED["to_host"] += 1
        _STAGED["to_host_bytes"] += host.numel() * host.element_size()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    out = torch.stack(parts)
    if t.device.type != "cpu":
        out = out.to(t.device)
        _STAGED["to_device"] += 1
        _STAGED["to_device_bytes"] += out.numel() * out.element_size()
    return out


def staged_transfers() -> dict[str, int]:
    """Copies made to stage collectives through host memory, and their
    bytes: ``to_host``, ``to_host_bytes``, ``to_device``,
    ``to_device_bytes``."""
    return {k: _STAGED[k] for k in ("to_host", "to_host_bytes", "to_device",
                                    "to_device_bytes")}


def reset_staged() -> None:
    _STAGED.clear()


# -------------------------------------------------------------------- ranks

def _rank_main(fn, rank: int, world: int, device_type: str, store: str,
               results, args) -> None:
    """One rank: join the gloo group, run fn(*args), report its return
    value (or the traceback) on `results`."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the rank's boundary: report, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, *args, device_type: str = "cpu",
          store_path, timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on `world` ranks, each a process started with the
    ``spawn`` method inside a gloo process group initialised from the file
    store `store_path` (which must not exist yet; it is removed after).
    `fn` must be importable by path from a module of the port, and its
    arguments and return value picklable (return host data, never a CUDA
    tensor).  On ``device_type="cuda"`` every rank sets device 0; on the
    CPU each rank runs one thread.

    Returns the ranks' return values in rank order.  Raises RuntimeError
    with a rank's traceback when one fails, or when the ranks do not all
    report within `timeout` seconds; every started process is ended
    before it returns or raises."""
    store = Path(store_path)
    if store.exists():
        raise ValueError(f"store {store} exists: give each spawn a new path")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, rank, world, device_type, str(store), results, args),
        daemon=True) for rank in range(world)]
    got, quiet = {}, 0
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{world} ranks of {fn.__name__} did "
                                       f"not report within {timeout} s")
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                quiet = quiet + 1 if dead else 0
                if quiet > 5:  # a rank died without a report (killed)
                    raise RuntimeError(f"a rank of {fn.__name__} exited "
                                       f"with {dead} and no report")
                continue
            if not ok:  # the others may wait on it in a collective
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:"
                                   f"\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        if store.exists():
            os.unlink(store)
