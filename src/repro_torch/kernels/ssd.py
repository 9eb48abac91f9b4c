"""The Mamba2 SSD chunk scan on Hopper.

Replaces ``repro/kernels/ssd.py``'s ``_ssd_kernel`` (launched by
``ssd_scan``) on the SSM serving path: the selective state-space scan of
each Mamba2 mixer, in its chunked (matmul) form.  The kernel is
hand-written CUDA C++ in ``csrc/ssd.cu``, built by ``build.py`` and called
through ctypes; its header says what bounds it on the H100 and what its
design does about that.

  ssd_scan        the kernel wrapper: (y, final state)
  ssd_scan_plain  its plain PyTorch version: the TPU kernel's arithmetic,
                  chunk by chunk, with the carried state
  PLANS, plan_for the kernel's plans and the one picked from a shape

Both take the model's layout, x (Bt, S, H, P), dt and dA = dt·A (Bt, S, H)
fp32, B and C (Bt, S, G, N) with head h reading group h // (H / G) (no
per-head copy), and return y (Bt, S, H, P) in x's dtype and the final state
(Bt, H, P, N) fp32 that the prefill keeps as the layer's cache.  Any S:
the ragged last chunk acts as rows of dt = 0 (exact, as the JAX padding)
that write no y.  The wrapper runs the plain version only for a CPU
tensor; on a CUDA tensor it launches the kernel or raises.  `launches`
counts the kernel's calls (one a scan, whether the kernel runs as one
launch or three) and moves nowhere else.  Inference only, as the JAX
kernel (which has no VJP).

The kernel runs under an `SsdPlan`: the heads one "y" block serves from
its score tiles and the heads one "state" block walks.  `PLANS` are the
instantiated plans (their index is the id in ``csrc/ssd.cu``) and
`plan_for` picks one from the shape.  Every plan gives every output the
same bits, so a plan is a matter of speed only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (16, 32, 64, 128)  # the N the kernel is instantiated for
MAX_HEAD_DIM = 64  # the largest P the kernel takes
MAX_CHUNK = 256    # the largest chunk the kernel takes
TILE = 64          # rows of a query tile of a y block
SMS = 132          # streaming multiprocessors of an H100 SXM


class SsdPlan(NamedTuple):
    """A plan of the kernel: `y_heads` heads of one group share a y
    block's score tiles, and a state block walks `s_heads` heads, two at
    a time."""
    y_heads: int
    s_heads: int


# The instantiated plans; a plan's index is its id in csrc/ssd.cu.
PLANS = (SsdPlan(8, 4), SsdPlan(1, 1))

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P] * 10 + [_I] * 7
             + [ctypes.POINTER(ctypes.c_longlong), _I, _I])


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def plan_for(b: int, s: int, h: int, p: int, g: int, n: int,
             chunk: int) -> SsdPlan:
    """The plan for x (b, s, h, p) and B, C (b, s, g, n) in chunks of
    `chunk`: 8 heads a y block and 4 a state block where those y blocks
    fill the SMs, else one head a block (the serving shapes: batch 1, one
    short chunk).  On an H100 (kernels/time_ssd.py) this picked the faster
    plan at every shape timed: mamba2-1.3b's 4 x 1000 and 4 x 2048, batch-1
    prefills of 256 to 2048 tokens, the serving shapes and chip_smoke.py's
    SSD_GRID.  For speed only: every plan gives the same bits."""
    del p, n
    y_blocks = (-(-min(s, chunk) // TILE) * b * -(-s // chunk) * g
                * -(-(h // g) // PLANS[0].y_heads))
    return PLANS[0] if y_blocks >= SMS else PLANS[1]


def _plan_id(plan) -> int:
    """The kernel's id of `plan` (an `SsdPlan` or its tuple); ValueError
    when it is not instantiated."""
    plan = tuple(plan)
    if plan not in PLANS:
        raise ValueError(f"plan must be one of {PLANS}, got {plan}")
    return PLANS.index(plan)


def check_operands(x, dt, B, C, *, chunk: int, dA=None, A=None,
                   init_state=None) -> None:
    """The SSD contract (see the module docstring), checked once at
    dispatch: x (Bt, S, H, P) and B, C (Bt, S, G, N) in one of `DTYPES`
    with G dividing H, dt (and dA when given) (Bt, S, H) fp32, A (when
    given) (H,), init_state None or (Bt, H, P, N) fp32.  Raises ValueError
    / TypeError naming the offending operand."""
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"need x (Bt, S, H, P) and B, C (Bt, S, G, N); got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    bt, s, h, p = x.shape
    g = B.shape[2]
    if B.shape[:2] != (bt, s) or g < 1 or h % g:
        raise ValueError(f"x {tuple(x.shape)} and B {tuple(B.shape)} disagree "
                         f"on batch or length, or G={g} does not divide H={h}")
    for name, t in (("dt", dt), ("dA", dA)):
        if t is not None and (t.shape != (bt, s, h)
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({bt}, {s}, {h}) float32; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if A is not None and tuple(A.shape) != (h,):
        raise ValueError(f"A must be ({h},); got {tuple(A.shape)}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16; got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    want = (bt, h, p, B.shape[3])
    if init_state is not None and (tuple(init_state.shape) != want
                                   or init_state.dtype != torch.float32):
        raise ValueError(f"init_state must be {want} float32; got "
                         f"{init_state.dtype} {tuple(init_state.shape)}")


def ssd_scan_plain(x, dt, dA, B, C, *, chunk: int, init_state=None):
    """The kernel's function in plain PyTorch, fp32 arithmetic, one chunk
    of `chunk` rows at a time (the last may be shorter): x̄ = x·dt,
    cs = cumsum(dA) within the chunk,
    y = ((C·Bᵀ) ∘ exp(segsum)) · x̄ + exp(cs) ∘ (C·stateᵀ), then
    state = exp(cs_last)·state + (x̄ ∘ exp(cs_last − cs))ᵀ · B.
    Returns (y (Bt, S, H, P) in x's dtype, state (Bt, H, P, N) fp32)."""
    check_operands(x, dt, B, C, chunk=chunk, dA=dA, init_state=init_state)
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    state = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        q = c1 - c0
        xbar = x[:, c0:c1].float() * dt[:, c0:c1, :, None]    # (Bt,q,H,P)
        cs = torch.cumsum(dA[:, c0:c1], dim=1)                 # (Bt,q,H)
        bc, cc = B[:, c0:c1].float(), C[:, c0:c1].float()      # (Bt,q,G,N)
        causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        diff = cs[:, :, None, :] - cs[:, None, :, :]           # (Bt,q,k,H)
        seg = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
        seg = seg.permute(0, 3, 1, 2).reshape(bt, g, rep, q, q)
        scores = torch.einsum("bqgn,bkgn->bgqk", cc, bc)
        xg = xbar.reshape(bt, q, g, rep, p)
        y = torch.einsum("bgrqk,bkgrp->bqgrp", scores[:, :, None] * seg, xg)
        y_off = torch.einsum("bqgn,bgrpn->bqgrp", cc,
                             state.reshape(bt, g, rep, p, n))
        y = y + torch.exp(cs).reshape(bt, q, g, rep, 1) * y_off
        ys.append(y.reshape(bt, q, h, p))
        decay_in = torch.exp(cs[:, -1:] - cs)                  # (Bt,q,H)
        new = torch.einsum("bkgrp,bkgn->bgrpn",
                           (xbar * decay_in[..., None]).reshape(
                               bt, q, g, rep, p), bc)
        state = (torch.exp(cs[:, -1])[..., None, None] * state
                 + new.reshape(bt, h, p, n))
    y = (torch.cat(ys, dim=1) if ys else
         torch.zeros_like(x, dtype=torch.float32))
    return y.to(x.dtype), state


def ssd_scan(x, dt, dA, B, C, *, chunk: int, init_state=None, plan=None):
    """The SSD chunk scan (see the module docstring): a CPU tensor runs
    `ssd_scan_plain`; a CUDA tensor launches ``csrc/ssd.cu`` on PyTorch's
    current stream and raises RuntimeError if the launch fails.  `plan` is
    one of `PLANS` (default `plan_for` the shape); one that is not
    instantiated raises ValueError.  On the card x, B and C must be
    contiguous along their last dim, dt and dA contiguous, N one of
    `STATE_DIMS`, P at most `MAX_HEAD_DIM` and the chunk at most
    `MAX_CHUNK`."""
    check_operands(x, dt, B, C, chunk=chunk, dA=dA, init_state=init_state)
    plan_id = _plan_id(plan_for(*x.shape, *B.shape[2:], chunk)
                       if plan is None else plan)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, dA, B, C, chunk=chunk,
                              init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    for name, t in (("dt", dt), ("dA", dA), ("B", B), ("C", C),
                    ("init_state", init_state)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} is not one of {STATE_DIMS}")
    if p > MAX_HEAD_DIM or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes P <= {MAX_HEAD_DIM} and chunks "
                         f"<= {MAX_CHUNK}; got P={p}, chunk={chunk}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along its last dim")
    if not (dt.is_contiguous() and dA.is_contiguous()):
        raise ValueError("dt and dA must be contiguous")
    if init_state is not None and not init_state.is_contiguous():
        raise ValueError("init_state must be contiguous")
    y = torch.empty((bt, s, h, p), dtype=x.dtype, device=x.device)
    if s == 0 or y.numel() == 0:
        state = (torch.zeros((bt, h, p, n), dtype=torch.float32,
                             device=x.device)
                 if init_state is None else init_state.clone())
        return y, state
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    # with more than one chunk: each chunk's own state contribution, then
    # the state entering it, and exp(cs_last) per chunk and head
    nc = -(-s // chunk)
    nw = dec = None
    if nc > 1:
        nw = torch.empty((bt, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
        dec = torch.empty((bt, nc, h), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3])
    build.launch(
        "ssd", "ssd_scan", _ARGTYPES,
        torch.cuda.current_stream(x.device).cuda_stream,
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(),
        None if nw is None else nw.data_ptr(),
        None if dec is None else dec.data_ptr(), bt, s, h, g, p, n, chunk,
        strides, DTYPES[x.dtype], plan_id,
        what=f"x {tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk}, "
             f"plan {PLANS[plan_id]}")
    global launches
    launches += 1
    return y, state
