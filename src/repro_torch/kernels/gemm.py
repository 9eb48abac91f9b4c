"""The paper's "Innovative Compute Engine" on Hopper: the fused GEMM
``y = act((x @ w) * scale + shift)``, forward.

Replaces ``repro/kernels/gemm.py::_gemm_kernel`` (launched by
``_gemm_forward``).  The kernel is hand-written CUDA C++ in
``csrc/gemm.cu``, built by ``build.py`` into a library with a plain C
interface and called through ctypes.  The header of ``csrc/gemm.cu`` says
what bounds it on the H100 (the fp32 FFMA rate: under ``fp32_strict`` there
are no tensor cores) and what its design does about that.

Three pieces, side by side:

  gemm_fused_fwd   the wrapper: checks device, dtype, shape and contiguity,
                   allocates the output, and launches the kernel on PyTorch's
                   current stream for a CUDA tensor; only for a CPU tensor
                   does it run the plain version instead.  A failed build or
                   launch raises; nothing falls back.
  gemm_fused_plain the plain PyTorch version of the same function (fp32
                   torch.matmul, then the epilogue): the CPU path, and what
                   the kernel is held against on the card.
  launches         the count of kernel launches, so a run can show that its
                   path went through the kernel (`reset_launches`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import ACTIVATIONS, epilogue

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILES = (64, 32)  # the square output tiles the kernel is instantiated for

launches = 0


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def gemm_fused_plain(x, w, scale=None, shift=None, *, act: str = "linear",
                     out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 products and fp32
    accumulation (TF32 off on the card), then the epilogue in fp32."""
    acc = torch.matmul(x.float(), w.float())
    return epilogue(acc, scale, shift, act).to(out_dtype or x.dtype)


def _check(x, w, scale, shift, act, out_dtype):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {act!r}")
    n = w.shape[1]
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.shape != (n,) or v.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 ({n},); got "
                             f"{v.dtype} {tuple(v.shape)}")


_FN = None


def _kernel():
    """The bound C entry point, built and loaded on first use."""
    global _FN
    if _FN is None:
        fn = build.load("gemm").gemm_fused_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _error_string(code: int) -> str:
    fn = build.load("gemm").gemm_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def gemm_fused_fwd(x, w, scale=None, shift=None, *, act: str = "linear",
                   out_dtype=None, tile: int = 64) -> torch.Tensor:
    """act((x @ w) * scale + shift) for x (M, K), w (K, N) row-major.

    x and w share float32 or bfloat16; scale/shift are float32 (N,) or
    None; the result is (M, N) in `out_dtype` (default x.dtype), with fp32
    accumulation.  `tile` is the square output tile (one of `TILES`).
    A CPU tensor runs `gemm_fused_plain`; a CUDA tensor launches the kernel
    and raises RuntimeError if the launch fails.
    """
    out_dtype = out_dtype or x.dtype
    _check(x, w, scale, shift, act, out_dtype)
    if x.device.type == "cpu":
        return gemm_fused_plain(x, w, scale, shift, act=act,
                                out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_fused_fwd runs on cuda or cpu, not "
                         f"{x.device}")
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    for name, v in (("x", x), ("w", w), ("scale", scale), ("shift", shift)):
        if v is None:
            continue
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if max(m, k, n) >= 2**31:
        raise ValueError(f"dimension too large for the kernel: {(m, k, n)}")
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    rc = _kernel()(
        x.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(),
        y.data_ptr(), m, k, n, _DTYPES[x.dtype], _DTYPES[out_dtype],
        ACTIVATIONS.index(act), tile,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gemm_fused_fwd launch failed for (M, K, N) = "
                           f"{(m, k, n)}: {_error_string(rc)}")
    global launches
    launches += 1
    return y
