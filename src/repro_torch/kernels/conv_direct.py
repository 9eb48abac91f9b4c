"""The direct (implicit-GEMM) convolution on Hopper.

Replaces ``repro/kernels/conv_direct.py``'s ``_band_kernel`` (launched by
``conv2d_direct``): a stride-1 VALID convolution of a pre-padded NHWC
input in which the im2col patches never exist; every (kh, kw) tap reads a
shifted window of the input.  The kernel is hand-written CUDA C++ in
``csrc/conv_direct.cu``, built by ``build.py`` and called through ctypes;
its header says what bounds it on the H100 and what its design does about
that.  Unlike the TPU wrapper, which copies overlapping halo bands out of
x because BlockSpecs cannot overlap, the kernel reads each band in place.

  conv2d_direct        the kernel wrapper
  conv2d_direct_plain  its plain PyTorch version: a loop over the taps in
                       the JAX order (kh, kw), fp32 products of each
                       shifted window with w[kh, kw], summed in fp32

Both take x (B, H, W, Cin) pre-padded and w (KH, KW, Cin, Cout) in one
dtype, float32 or bfloat16, and return (B, H - KH + 1, W - KW + 1, Cout)
in x's dtype.  The wrapper runs the plain version only for a CPU tensor;
on a CUDA tensor it launches the kernel or raises.  `launches` counts the
kernel's launches and moves nowhere else.

FORWARD ONLY, as the JAX kernel (which has no custom VJP): a call that
would need a gradient raises NotImplementedError.  No backend of the
registry registers it, as in the JAX package; the engine's `conv2d` is the
im2col GEMM, which is differentiable.  A backend that registers this
kernel as its `conv2d` (padding outside, stride 1) must leave "conv2d" out
of `differentiable`, so the engine's guard raises its capability error
before the kernel is reached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import needs_grad

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_PIXELS = 64         # a block's output pixels: th rows x 64 // th columns
MAX_SMEM = 232448        # bytes of shared memory one block may use

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 9


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def smem_bytes(th: int, kh: int, kw: int) -> int:
    """Shared memory of one block at band height `th` and a KH x KW
    kernel: the fp32 input patch and weights of one chunk of 8 input
    channels for 64 output channels (``csrc/conv_direct.cu``)."""
    tw = TILE_PIXELS // th
    return ((th + kh - 1) * (tw + kw - 1) * 8 + kh * kw * 8 * 64) * 4


def _check(x, w, th):
    """Shapes, dtypes and the band height; returns (OH, OW, th) with th
    clamped to OH as the JAX wrapper clamps it."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"need x (B, H, W, Cin) and w (KH, KW, Cin, Cout); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    _, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    if kh < 1 or kw < 1 or kh > h or kw > wd:
        raise ValueError(f"kernel {kh} x {kw} does not fit the padded input "
                         f"{h} x {wd}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    oh, ow = h - kh + 1, wd - kw + 1
    th = min(th, oh)
    if not 1 <= th <= TILE_PIXELS:
        raise ValueError(f"th must be in 1..{TILE_PIXELS} (after clamping "
                         f"to OH = {oh}); got {th}")
    return oh, ow, th


def conv2d_direct_plain(x, w) -> torch.Tensor:
    """The kernel's function in plain PyTorch: for each tap (kh, kw) in
    order, the shifted window x[:, kh:kh+OH, kw:kw+OW, :] times w[kh, kw]
    in fp32 (TF32 off on the card), added into an fp32 accumulator; the
    result in x's dtype."""
    _, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    oh, ow = h - kh + 1, wd - kw + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros((x.shape[0], oh, ow, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc += torch.matmul(xf[:, i:i + oh, j:j + ow, :], wf[i, j])
    return acc.to(x.dtype)


def conv2d_direct(x, w, *, th: int = 8) -> torch.Tensor:
    """Stride-1 VALID convolution of the pre-padded NHWC x (B, H, W, Cin)
    with w (KH, KW, Cin, Cout) -> (B, H - KH + 1, W - KW + 1, Cout) in x's
    dtype, fp32 accumulation (see the module docstring).

    `th` is the band of output rows one block computes (clamped to OH, as
    the JAX wrapper clamps it; at most 64); it changes the tiling, not the
    result.  Raises NotImplementedError when grad is enabled and x or w
    requires it: the kernel is forward only.  A CPU tensor runs
    `conv2d_direct_plain`; a CUDA tensor launches ``csrc/conv_direct.cu``
    on PyTorch's current stream and raises RuntimeError if the launch
    fails.  On the card x and w must be contiguous.
    """
    if needs_grad(x, w):
        raise NotImplementedError(
            "conv2d_direct is forward only (as the JAX kernel, which has no "
            "custom VJP): differentiate the engine's conv2d, the im2col GEMM, "
            "instead")
    oh, ow, th = _check(x, w, th)
    if x.device.type == "cpu":
        return conv2d_direct_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct runs on cuda or cpu, not {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    if smem_bytes(th, kh, kw) > MAX_SMEM:
        raise ValueError(f"a {kh} x {kw} kernel at th={th} needs "
                         f"{smem_bytes(th, kh, kw)} bytes of shared memory, "
                         f"more than a block's {MAX_SMEM}")
    y = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    build.launch("conv_direct", "conv_direct", _ARGTYPES,
                 torch.cuda.current_stream(x.device).cuda_stream,
                 x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin, kh,
                 kw, cout, th, DTYPES[x.dtype],
                 what=f"x {tuple(x.shape)}, w {tuple(w.shape)}, th {th}")
    global launches
    launches += 1
    return y
