"""Any-shape wrappers over the port's kernels (PyTorch port of
``repro/kernels/ops.py::matmul``).

The JAX wrapper pads (M, K, N) up to tile multiples and slices the result,
because its TPU kernel's BlockSpecs need whole blocks.  The port's CUDA
kernel masks the ragged edges itself (bounds-checked, zero-filled tile
loads and a masked store), so this wrapper does NOT pad: it only makes the
operands contiguous and picks the tile.  Any (M, K, N) runs, the property
of the paper's Figure 3.

With grad enabled and an operand that requires it, `matmul` goes through
`gemm.GemmFused`: the forward kernel also writes its training residuals
and the backward runs the dX / dW kernels.  Otherwise it makes the
forward-only launch that serving makes.

Tiles and the backward's split count are fixed heuristics
(`default_tiles`, `default_bwd_tiles`).  A measured autotuner, the
counterpart of ``repro/core/autotune.py``, is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gemm as gemm_kernel

# Below this many 64 x 64 output tiles the card's 132 SMs are not kept
# busy, so the 32 x 32 tile (four times as many blocks) is used instead.
_MIN_BLOCKS_64 = 264
# A backward GEMM whose output tiles give fewer threads than half of what
# the card holds resident (132 SMs x 2048) splits its contraction until
# they do, each piece at least _MIN_SPLIT_DEPTH long.
_SPLIT_THREADS = 132 * 1024
_MIN_SPLIT_DEPTH = 512
BWD_VARIANTS = ("dx", "dw")


def default_tiles(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(bm, bk, bn) for an (M, K, N) GEMM: 64 x 64 output tiles when the
    problem has enough of them to fill the card, else 32 x 32; the K stage
    is always 16 deep.  The tile never changes an output element's
    summation order (the kernel has no split-K), only the speed."""
    blocks = -(-m // 64) * -(-n // 64)
    t = 64 if blocks >= _MIN_BLOCKS_64 and n > 32 else 32
    return (t, 16, t)


def default_bwd_tiles(variant: str, rows: int, kdim: int, cols: int
                      ) -> tuple[int, int, int, int]:
    """(bm, bk, bn, splits) for a backward GEMM over its own (rows,
    contraction, cols): ("dx", M, N, K) or ("dw", K, M, N).  The tile is
    `default_tiles`' for that problem.  When the output tiles' threads
    would fill less than half the card, the contraction is split into
    enough pieces to reach `_SPLIT_THREADS`, none shorter than
    `_MIN_SPLIT_DEPTH`.
    The split depends on the shape alone, so a result has the same bits
    run to run (the counterpart of ``default_gemm_bwd_blocks``)."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown backward variant {variant!r}; expected "
                         f"one of {BWD_VARIANTS}")
    t, bk, _ = default_tiles(rows, kdim, cols)
    threads = -(-rows // t) * -(-cols // t) * (t // 4) ** 2
    splits = max(1, min(-(-_SPLIT_THREADS // threads),
                        kdim // _MIN_SPLIT_DEPTH))
    return (t, bk, t, gemm_kernel.split_chunk(kdim, splits)[1])


def matmul(x, w, scale=None, shift=None, *, act: str = "linear",
           out_dtype=None, tiles: tuple = ()) -> torch.Tensor:
    """Fused GEMM act((x @ w) * scale + shift) on the compute engine, any
    (M, K) x (K, N).

    scale/shift are (N,) vectors (cast to float32) or None; `tiles` pins
    (bm, bk, bn), else `default_tiles` picks.  Differentiable: with grad
    enabled and an operand that requires it, the call goes through
    `gemm.GemmFused`, whose backward uses `default_bwd_tiles`.  On a CPU
    tensor the kernel wrappers run their plain versions.
    """
    m, k = x.shape
    n = w.shape[1]
    bm = (tiles or default_tiles(m, k, n))[0]
    x, w = x.contiguous(), w.contiguous()
    scale = None if scale is None else scale.float().contiguous()
    shift = None if shift is None else shift.float().contiguous()
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale, shift)):
        dx_plan = default_bwd_tiles("dx", m, n, k)
        dw_plan = default_bwd_tiles("dw", k, m, n)
        return gemm_kernel.GemmFused.apply(
            x, w, scale, shift, act, out_dtype, bm,
            (dx_plan[0], dx_plan[3]), (dw_plan[0], dw_plan[3]))
    return gemm_kernel.gemm_fused_fwd(x, w, scale, shift, act=act,
                                      out_dtype=out_dtype, tile=bm)
