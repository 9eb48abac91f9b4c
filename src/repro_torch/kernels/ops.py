"""Any-shape wrappers over the port's kernels (PyTorch port of
``repro/kernels/ops.py::matmul``).

The JAX wrapper pads (M, K, N) up to tile multiples and slices the result,
because its TPU kernel's BlockSpecs need whole blocks.  The port's CUDA
kernel masks the ragged edges itself (bounds-checked, zero-filled tile
loads and a masked store), so this wrapper does NOT pad: it only makes the
operands contiguous and picks the tile.  Any (M, K, N) runs, the property
of the paper's Figure 3.

The tile is a fixed heuristic (`default_tiles`).  A measured autotuner,
the counterpart of ``repro/core/autotune.py``, is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gemm as gemm_kernel

# Below this many 64 x 64 output tiles the card's 132 SMs are not kept
# busy, so the 32 x 32 tile (four times as many blocks) is used instead.
_MIN_BLOCKS_64 = 264


def default_tiles(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(bm, bk, bn) for an (M, K, N) GEMM: 64 x 64 output tiles when the
    problem has enough of them to fill the card, else 32 x 32; the K stage
    is always 16 deep.  The tile never changes an output element's
    summation order (the kernel has no split-K), only the speed."""
    blocks = -(-m // 64) * -(-n // 64)
    t = 64 if blocks >= _MIN_BLOCKS_64 and n > 32 else 32
    return (t, 16, t)


def matmul(x, w, scale=None, shift=None, *, act: str = "linear",
           out_dtype=None, tiles: tuple = ()) -> torch.Tensor:
    """Fused GEMM act((x @ w) * scale + shift) on the compute engine, any
    (M, K) x (K, N).

    scale/shift are (N,) vectors (cast to float32) or None; `tiles` pins
    (bm, bk, bn), else `default_tiles` picks.  On a CPU tensor the kernel
    wrapper runs its plain version.
    """
    m, k = x.shape
    n = w.shape[1]
    bm = (tiles or default_tiles(m, k, n))[0]
    scale = None if scale is None else scale.float().contiguous()
    shift = None if shift is None else shift.float().contiguous()
    return gemm_kernel.gemm_fused_fwd(
        x.contiguous(), w.contiguous(), scale, shift, act=act,
        out_dtype=out_dtype or x.dtype, tile=bm)
