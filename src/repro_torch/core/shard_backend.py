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
JAX's sharded backend lacks, run the `cuda` formulations unsharded on
every rank: the SSD kernel, or under grad the einsum form
(`backends.kernel_or_einsum_ssd`), and `backends.einsum_as_bmm`.

Every op is differentiable, as on `cuda`: the sharded ops through the
autograd primitives of kernels/sharded.py (the per-shard backward
kernels, the input cotangents gathered, the weight cotangents summed
over the ranks in rank order), `conv2d` through `Im2col`'s backward
over that matmul, `einsum` through `BmmFn`.  A decode-shaped attention
dispatch stays inference only (`backends.decode_inference_only`, the
`cuda` rule: the split-KV kernel and the sequence split have no
backward), so the engine's `guard_grad` refuses it under grad by name.
"""
from __future__ import annotations

from repro_torch.core import backends
from repro_torch.kernels import sharded


def _matmul(x, w, scale, shift, *, act, out_dtype, ctx):
    return sharded.matmul(x, w, scale, shift, act=act, out_dtype=out_dtype)


def _bmm(x, w, *, out_dtype, ctx):
    return sharded.bmm(x, w, out_dtype=out_dtype)


def _attention(q, k, v, *, causal, sm_scale, kv_len=None, ctx):
    return sharded.attention(q, k, v, kv_len, sm_scale, causal=causal)


def _einsum(spec, x, y, *, acc_dtype, out_dtype, ctx):
    return backends.einsum_as_bmm(spec, x, y, acc_dtype=acc_dtype,
                                  out_dtype=out_dtype)


backends.register_backend("sharded_cuda", {
    "matmul": _matmul,
    "bmm": _bmm,
    "conv2d": backends.im2col_conv2d(_matmul),
    "attention": _attention,
    "ssd": backends.kernel_or_einsum_ssd,
    "einsum": _einsum,
}, inference_only=backends.decode_inference_only)
