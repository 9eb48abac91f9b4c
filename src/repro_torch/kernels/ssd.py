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

Both take the model's layout, x (Bt, S, H, P), dt and dA = dt·A (Bt, S, H)
fp32, B and C (Bt, S, G, N) with head h reading group h // (H / G) (no
per-head copy), and return y (Bt, S, H, P) in x's dtype and the final state
(Bt, H, P, N) fp32 that the prefill keeps as the layer's cache.  Any S:
the ragged last chunk acts as rows of dt = 0 (exact, as the JAX padding)
that write no y.  The wrapper runs the plain version only for a CPU
tensor; on a CUDA tensor it launches the kernel or raises.  `launches`
counts the kernel's launches and moves nowhere else.  Inference only, as
the JAX kernel (which has no VJP).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (16, 32, 64, 128)  # the N the kernel is instantiated for

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P] * 8 + [_I] * 7 + [ctypes.POINTER(ctypes.c_longlong), _I])


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


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


def ssd_scan(x, dt, dA, B, C, *, chunk: int, init_state=None):
    """The SSD chunk scan (see the module docstring): a CPU tensor runs
    `ssd_scan_plain`; a CUDA tensor launches ``csrc/ssd.cu`` on PyTorch's
    current stream and raises RuntimeError if the launch fails.  On the
    card x, B and C must be contiguous along their last dim, dt and dA
    contiguous, N one of `STATE_DIMS`."""
    check_operands(x, dt, B, C, chunk=chunk, dA=dA, init_state=init_state)
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
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3])
    build.launch(
        "ssd", "ssd_scan", _ARGTYPES,
        torch.cuda.current_stream(x.device).cuda_stream,
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), bt, s, h, g, p, n, chunk, strides,
        DTYPES[x.dtype],
        what=f"x {tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk}")
    global launches
    launches += 1
    return y, state
