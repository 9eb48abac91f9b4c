"""The `sharded_cuda` backend: the hand-written kernel set run per shard of
the installed mesh (PyTorch port of ``repro/core/shard_backend.py``).

Registered through the public `register_backend` seam, this backend
slices each op's operands over the mesh `sharding.hints.use_mesh`
installed (batch and KV-head-group sharding per
`hints.current_strategy()`, a sequence-split partial-(o, lse) path for
decode-shaped attention; kernels/sharded.py gives the order), runs the
local kernel wrappers on the slices and gathers the outputs whole.  Off a
mesh every op is the local wrapper, so ``make_engine("sharded_cuda")`` is
safe at any scale; like `cuda` it defaults to the card, and on a CPU
device the wrappers run their plain versions per shard (the CPU tests).

No tile hooks are registered: the wrappers resolve their plans inside
the shard from the per-shard shapes under the `cuda` backend's keys, so
plan picks stay shard-local instead of keying on the global problem.

Sharded ops: `matmul`, `bmm`, `conv2d` (im2col over the sharded matmul:
the B·OH·OW patch rows shard) and `attention`.  `ssd` and `einsum`, which
JAX's sharded backend lacks, run the `cuda` formulations (the SSD kernel,
`backends.einsum_as_bmm`) unsharded on every rank.  Forward only: no op is
declared differentiable, so the engine's `guard_grad` refuses each one
under grad by name.
"""
from __future__ import annotations

from repro_torch.core import backends
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import sharded


def _matmul(x, w, scale, shift, *, act, out_dtype, ctx):
    return sharded.matmul(x, w, scale, shift, act=act, out_dtype=out_dtype)


def _bmm(x, w, *, out_dtype, ctx):
    return sharded.bmm(x, w, out_dtype=out_dtype)


def _attention(q, k, v, *, causal, sm_scale, kv_len=None, ctx):
    return sharded.attention(q, k, v, kv_len, sm_scale, causal=causal)


def _ssd(x, dt, A, B, C, *, chunk, init_state=None, ctx):
    return kernel_ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)


def _einsum(spec, x, y, *, acc_dtype, out_dtype, ctx):
    return backends.einsum_as_bmm(spec, x, y, acc_dtype=acc_dtype,
                                  out_dtype=out_dtype)


backends.register_backend("sharded_cuda", {
    "matmul": _matmul,
    "bmm": _bmm,
    "conv2d": backends.im2col_conv2d(_matmul),
    "attention": _attention,
    "ssd": _ssd,
    "einsum": _einsum,
}, differentiable=())
