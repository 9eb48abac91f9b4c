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
  PLANS, plan_for      the kernel's tilings and the one picked from a shape

Both take x (B, H, W, Cin) pre-padded and w (KH, KW, Cin, Cout) in one
dtype, float32 or bfloat16, and return (B, H - KH + 1, W - KW + 1, Cout)
in x's dtype.  The wrapper runs the plain version only for a CPU tensor;
on a CUDA tensor it launches the kernel or raises.  `launches` counts the
kernel's launches and moves nowhere else.

The kernel launches under a `ConvPlan`: how a block tiles the pixels
("first", "band", "strip" or "flat", see `ConvPlan`), each thread's TM
pixels by TN output channels, the block's RG x CG threads and the channels
of a stage.  `PLANS` are the instantiated plans (their index is the id in
``csrc/conv_direct.cu``) and `plan_for` picks one from the shape.  Every
plan gives every output the same bits (one fmaf chain per output in a
fixed order), so a plan is a matter of speed only.

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
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import needs_grad

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TH = 64              # the largest band height a caller may ask for
MAX_SMEM = 232448        # bytes of shared memory one block may use
GROUP = 8                # channels of one group of the accumulation order
STAGES = 2               # the ring's stages
SMS = 132                # streaming multiprocessors of an H100 SXM


class ConvPlan(NamedTuple):
    """A tiling of the kernel.  `kind`: "first" (few input channels: 32
    output channels, pixel rows of 32 columns, a patch row staged as its
    contiguous run in x), "band" (th output rows by 256 // th columns, th
    from the caller), "strip" (whole output rows, bm // OW of them) or
    "flat" (bm consecutive pixels of the flattened B * OH * OW rows, each
    tap's pixels staged apart: a GEMM for a 1 x 1 kernel, one 8-channel
    group a stage for a larger one).  A block of rg x cg threads computes
    bm = rg * tm pixels by bn = cg * tn output channels, ck input channels
    a stage."""
    kind: str
    tm: int
    tn: int
    rg: int
    cg: int
    ck: int

    @property
    def bm(self) -> int:
        return self.rg * self.tm

    @property
    def bn(self) -> int:
        return self.cg * self.tn


# The instantiated plans; a plan's index is its id in csrc/conv_direct.cu.
PLANS = (ConvPlan("first", 8, 8, 64, 4, 8),
         ConvPlan("band", 8, 8, 32, 8, 8),
         ConvPlan("strip", 8, 8, 32, 8, 8),
         ConvPlan("strip", 8, 4, 16, 16, 8),
         ConvPlan("flat", 8, 4, 16, 16, 32),
         ConvPlan("flat", 4, 4, 16, 16, 32),
         ConvPlan("flat", 4, 4, 8, 16, 32))

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 10


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def plan_for(b: int, h: int, w: int, cin: int, kh: int, kw: int,
             cout: int, *, dtype: torch.dtype = torch.float32) -> ConvPlan:
    """The plan for a pre-padded (b, h, w, cin) input and a kh x kw x cin
    x cout weight in `dtype`, as `time_conv.py` timed every plan at the
    DARKNET19 layers on an H100: "first" for up to 4 input channels; a
    1 x 1 kernel "flat" 64 x 64, or 32 x 64 blocks of 128 threads where
    64 x 64 blocks would give between one and two blocks per SM; a larger
    kernel "flat" 128 x 64 down to 56 output columns, then flat 64 x 64
    (fp32) or the 256 x 64 strip (bf16) down to 28, then the 128 x 64
    strip (fp32) or flat 32 x 64 blocks of 128 threads (bf16).  For speed
    only: every plan gives the same bits."""
    oh, ow = h - kh + 1, w - kw + 1
    if cin <= 4:
        return PLANS[0]
    if kh == kw == 1:
        blocks = -(-b * oh * ow // 64) * -(-cout // 64)
        return PLANS[6] if SMS < blocks <= 2 * SMS else PLANS[5]
    fp32 = dtype == torch.float32
    if ow > 28:
        return PLANS[4]
    if ow > 14:
        return PLANS[5] if fp32 else PLANS[2]
    return PLANS[3] if fp32 else PLANS[6]


def _plan_id(plan) -> int:
    """The kernel's id of `plan` (a `ConvPlan` or its tuple); ValueError
    when it is not instantiated."""
    plan = tuple(plan)
    if plan not in PLANS:
        raise ValueError(f"plan must be one of {PLANS}, got {plan}")
    return PLANS.index(plan)


def tile(plan: ConvPlan, th: int, oh: int, ow: int) -> tuple[int, int]:
    """(rows, columns) of the pixel tile of a 2-D `plan` at band height
    `th` (already clamped to `oh`), as ``csrc/conv_direct.cu`` shapes it."""
    if plan.kind == "first":
        tw = min(ow, 32)
        return min(plan.bm // tw, oh), tw
    if plan.kind == "band":
        return th, min(ow, max(1, plan.bm // th))
    tw = min(ow, plan.bm)
    return min(plan.bm // tw, oh), tw


def smem_bytes(th: int, kh: int, kw: int, *, plan: ConvPlan = PLANS[1],
               oh: int = 64, ow: int = 64, itemsize: int = 4) -> int:
    """Shared memory of one block of `plan` (``csrc/conv_direct.cu``'s
    `Layout`): `STAGES` stages of the input patch and the weights of one
    chunk of channels, in the operands' dtype (`itemsize` bytes), and the
    block's tables, for a KH x KW kernel, band height `th` and an
    `oh` x `ow` output."""
    vec = 16 // itemsize
    taps = kh * kw
    ck = GROUP if plan.kind == "flat" and taps > 1 else plan.ck
    tables = 0
    if plan.kind == "flat":
        patch = taps * plan.bm * ck
        tables = plan.bm + taps
    else:
        rows, tw = tile(plan, min(th, oh), oh, ow)
        ph, pw = rows + kh - 1, tw + kw - 1
        if plan.kind == "first":
            ldr = -(-pw * GROUP // vec) * vec + vec
            patch, tables = ph * ldr, ph
        else:
            patch = ph * pw * ck
    patch = -(-patch // vec) * vec
    return (STAGES * (patch + taps * ck * plan.bn) * itemsize
            + 4 * tables)


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
    if not 1 <= th <= MAX_TH:
        raise ValueError(f"th must be in 1..{MAX_TH} (after clamping "
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


def conv2d_direct(x, w, *, th: int = 8, plan=None) -> torch.Tensor:
    """Stride-1 VALID convolution of the pre-padded NHWC x (B, H, W, Cin)
    with w (KH, KW, Cin, Cout) -> (B, H - KH + 1, W - KW + 1, Cout) in x's
    dtype, fp32 accumulation (see the module docstring).

    `plan` is one of `PLANS` (default `plan_for` the shape); one that is
    not instantiated raises ValueError.  `th` is checked as the JAX
    wrapper checks it (clamped to OH, then 1..64): a "band" plan computes
    bands of th output rows; "first" and "strip" plans shape their pixel
    tiles to the output width and "flat" plans tile the flattened pixels,
    so they do not read it.  Neither changes the result.  Raises
    NotImplementedError when grad is enabled and x or w
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
    plan_id = _plan_id(plan_for(*x.shape, *w.shape[:2], w.shape[3],
                                dtype=x.dtype) if plan is None else plan)
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
    plan = PLANS[plan_id]
    need = smem_bytes(th, kh, kw, plan=plan, oh=oh, ow=ow,
                      itemsize=x.element_size())
    if need > MAX_SMEM:
        raise ValueError(f"a {kh} x {kw} kernel at th={th} under {plan} "
                         f"needs {need} bytes of shared memory, more than a "
                         f"block's {MAX_SMEM}")
    y = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    build.launch("conv_direct", "conv_direct", _ARGTYPES,
                 torch.cuda.current_stream(x.device).cuda_stream,
                 x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin, kh,
                 kw, cout, th, DTYPES[x.dtype], plan_id,
                 what=f"x {tuple(x.shape)}, w {tuple(w.shape)}, th {th}, "
                      f"plan {plan}")
    global launches
    launches += 1
    return y
