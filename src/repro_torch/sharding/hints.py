"""Activation-sharding hints that degrade to no-ops off-mesh (PyTorch port
of ``repro/sharding/hints.py``).

Model code names *logical* axis tags; a mesh installed with `use_mesh` (a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, see
`launch/mesh.py`) resolves them to its dims.  Off-mesh every helper is a
no-op, so model code stays mesh-agnostic.

Tags:  "dp"    -> every batch-parallel dim present (("pod", "data"))
       "model" -> the tensor-parallel dim
       None    -> unsharded dim

The port has no GSPMD: `shard` returns its tensor unchanged and `pspec`
only names the resolved dims.  Distribution is the `sharded_cuda`
backend's business (core/shard_backend.py, kernels/sharded.py), which
reads the installed mesh (`physical_mesh`) and the strategy at dispatch.
"""
from __future__ import annotations

import contextlib

# Distribution strategy (set by the launcher, read at dispatch):
#   tp   : batch over (pod, data); tensors over 'model' (Megatron TP)
#   fsdp : batch over ALL dims (pure ZeRO-3); the 'model' tag resolves to
#          None (the model dim carries batch)
_STRATEGY = "tp"
# The mesh `use_mesh` installed, or None off-mesh.
_MESH = None


@contextlib.contextmanager
def strategy(name: str):
    """Context manager setting the distribution strategy ("tp" or
    "fsdp"); ValueError for any other name."""
    global _STRATEGY
    if name not in ("tp", "fsdp"):
        raise ValueError(f"strategy must be 'tp' or 'fsdp', got {name!r}")
    prev = _STRATEGY
    _STRATEGY = name
    try:
        yield
    finally:
        _STRATEGY = prev


def current_strategy() -> str:
    return _STRATEGY


def batch_axes() -> tuple:
    """The mesh dims that carry the batch under the current strategy."""
    return (("pod", "data", "model") if _STRATEGY == "fsdp"
            else ("pod", "data"))


def physical_mesh():
    """The mesh installed by `use_mesh`, or None off-mesh: the mesh the
    sharded backend (core/shard_backend.py, kernels/sharded.py) slices
    operands over."""
    return _MESH


def _axis_names() -> tuple:
    return () if _MESH is None else tuple(_MESH.mesh_dim_names)


def mesh_active() -> bool:
    """True when a mesh is installed.  Model code does not fork on it: the
    backend distributes at dispatch; it remains for launchers and
    diagnostics."""
    return bool(_axis_names())


def mesh_topology(mesh=None) -> tuple:
    """((dim, size), ...) of `mesh` (default: the installed one), or ()
    off-mesh.  A hashable topology fingerprint: the paged engine folds it
    into its `StepCompileCache` keys, so a step built under one mesh is
    never counted under another."""
    if mesh is None:
        mesh = _MESH
    if mesh is None:
        return ()
    return tuple((str(a), int(n))
                 for a, n in zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def _installed(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def use_mesh(mesh):
    """Context manager installing `mesh` as the ambient mesh for the
    duration; None gives a null context, so callers can write ``with
    use_mesh(self.mesh):`` unconditionally."""
    return contextlib.nullcontext() if mesh is None else _installed(mesh)


def resolve(tag):
    """Logical tag -> mesh dim (a tuple of dims for "dp"), or None when
    absent from the installed mesh."""
    names = _axis_names()
    if tag is None:
        return None
    if tag == "dp":
        axes = tuple(a for a in batch_axes() if a in names)
        return axes if axes else None
    if tag == "model" and _STRATEGY == "fsdp":
        return None  # the model dim carries batch under pure FSDP
    if tag in names:
        return tag
    return None


def shard(x, *tags):
    """A sharding hint: returns `x` unchanged.  The port has no GSPMD to
    hand a constraint to; the sharded backend slices operands itself."""
    return x


def pspec(*tags) -> tuple:
    """The resolved dims of `tags` (JAX's PartitionSpec as a tuple)."""
    return tuple(resolve(t) for t in tags)
