"""The Mamba2 / SSD (state-space duality) mixer on the compute engine
(PyTorch port of ``repro/models/ssm.py``).

Five projections of the input (z, x, B, C, dt, each a GEMM on the engine),
a depthwise causal conv with silu on x, B and C, the SSD scan on the
engine's `ssd` op (on `cuda` the hand-written chunk-scan kernel, on `eager`
the JAX einsum formulation), the D skip, a gated RMSNorm and the output
projection.  Decode is the O(1) recurrence
state' = exp(dt·A)·state + dt·x ⊗ B on the conv tails and the state of the
cache.

Parameters follow the JAX layout and initialisation rules (other numbers:
they are drawn from a `torch.Generator`); `convert.lm_params_from_jax`
carries a JAX tree across.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ComputeEngine
from repro_torch.models.common import rmsnorm

CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def ssm_init(generator: torch.Generator, cfg, device=None) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    h, n, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv = cfg.ssm_conv
    sd = 1.0 / d ** 0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def zeros(size):
        return torch.zeros(size, device=device)

    return {
        "wz": normal((d, di), sd), "wx": normal((d, di), sd),
        "wB": normal((d, g * n), sd), "wC": normal((d, g * n), sd),
        "wdt": normal((d, h), sd),
        "dt_bias": zeros(h),
        "A_log": zeros(h),                     # A = -exp(A_log) = -1
        "D": torch.ones(h, device=device),
        "conv_x": normal((conv, di), 0.2), "conv_x_b": zeros(di),
        "conv_B": normal((conv, g * n), 0.2), "conv_B_b": zeros(g * n),
        "conv_C": normal((conv, g * n), 0.2), "conv_C_b": zeros(g * n),
        "norm": {"scale": torch.ones(di, device=device)},
        "out": normal((di, d), 1.0 / di ** 0.5),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv with silu.  x (B, S, C); w (conv, C); b (C,)
    -> (B, S, C), in the promoted dtype of x and w (fp32 for fp32
    parameters), as in JAX."""
    conv, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, conv - 1, 0))
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(conv))
    return F.silu(y + b)


def ssd_chunked(engine: ComputeEngine, x, dt, A, Bm, Cm, chunk: int,
                init_state=None):
    """The SSD scan in chunked form, through the engine's `ssd` op.

    x (B, S, H, P); dt (B, S, H), already softplus'ed; A (H,) negative;
    Bm, Cm (B, S, G, N).  Returns (y (B, S, H, P), state (B, H, P, N)
    fp32)."""
    return engine.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)


def _tail(t, rows: int):
    """The last `rows` rows of (B, S, C) along S, zero-padded in front
    when S is shorter (the causal conv's own padding)."""
    if t.shape[1] < rows:
        t = F.pad(t, (0, 0, rows - t.shape[1], 0))
    return t[:, t.shape[1] - rows:, :]


def ssm_forward(engine: ComputeEngine, p: dict, x, cfg, *,
                return_cache: bool = False):
    """The full-sequence Mamba2 mixer.  x (B, S, D) -> (B, S, D); with
    ``return_cache`` also the layer's cache: the last conv - 1 rows of the
    x, B and C projections (before the conv) and the final SSD state."""
    b, s, _ = x.shape
    h, hp, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                   cfg.ssm_ngroups)
    z = engine.matmul(x, p["wz"])
    xin = engine.matmul(x, p["wx"])
    bin_ = engine.matmul(x, p["wB"])
    cin = engine.matmul(x, p["wC"])
    dt_raw = engine.matmul(x, p["wdt"], out_dtype=torch.float32)
    xc = causal_conv1d(xin, p["conv_x"], p["conv_x_b"])
    bc = causal_conv1d(bin_, p["conv_B"], p["conv_B_b"])
    cc = causal_conv1d(cin, p["conv_C"], p["conv_C_b"])
    dt = F.softplus(dt_raw + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = xc.reshape(b, s, h, hp)
    y, state = ssd_chunked(engine, xh, dt, a, bc.reshape(b, s, g, n),
                           cc.reshape(b, s, g, n), cfg.ssm_chunk)
    y = y.float() + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, h * hp).to(x.dtype)
    y = rmsnorm((y.float() * F.silu(z.float())).to(x.dtype),
                p["norm"]["scale"], cfg.norm_eps)
    out = engine.matmul(y, p["out"])
    if not return_cache:
        return out
    rows = cfg.ssm_conv - 1
    return out, {"conv_x": _tail(xin, rows), "conv_B": _tail(bin_, rows),
                 "conv_C": _tail(cin, rows), "ssm": state}


def _step_conv(state, new, w, b):
    """One decode step of the causal conv: state (B, conv - 1, C), new
    (B, C) -> (silu output (B, C) fp32, the next state)."""
    win = torch.cat([state, new[:, None, :].to(state.dtype)], dim=1)
    y = torch.einsum("btc,tc->bc", win.float(), w.float())
    return F.silu(y + b), win[:, 1:, :]


def ssm_decode(engine: ComputeEngine, p: dict, x, cache: dict, cfg):
    """One-token decode, the O(1) state update.  x (B, 1, D); cache the
    layer's {"conv_x", "conv_B", "conv_C", "ssm"}.  Returns (out (B, 1, D),
    the new cache, fresh tensors)."""
    b = x.shape[0]
    h, hp, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                   cfg.ssm_ngroups)
    z = engine.matmul(x, p["wz"])[:, 0]
    xin = engine.matmul(x, p["wx"])[:, 0]
    bin_ = engine.matmul(x, p["wB"])[:, 0]
    cin = engine.matmul(x, p["wC"])[:, 0]
    dt_raw = engine.matmul(x, p["wdt"], out_dtype=torch.float32)[:, 0]
    xc, conv_x = _step_conv(cache["conv_x"], xin, p["conv_x"], p["conv_x_b"])
    bc, conv_b = _step_conv(cache["conv_B"], bin_, p["conv_B"],
                            p["conv_B_b"])
    cc, conv_c = _step_conv(cache["conv_C"], cin, p["conv_C"], p["conv_C_b"])
    dt = F.softplus(dt_raw + p["dt_bias"])                # (B, H)
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a)                                # (B, H)
    xh = xc.reshape(b, h, hp).float()

    def heads(t):  # (B, G * N) -> (B, H, N), head h reads group h // (H/G)
        return (t.reshape(b, g, 1, n).expand(b, g, h // g, n)
                .reshape(b, h, n).float())

    state = cache["ssm"].float()
    state = (da[..., None, None] * state
             + (dt[..., None] * xh)[..., None] * heads(bc)[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, heads(cc))
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(b, h * hp)
    y = rmsnorm((y * F.silu(z.float())).to(x.dtype), p["norm"]["scale"],
                cfg.norm_eps)
    out = engine.matmul(y[:, None, :], p["out"])
    return out, {"conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c,
                 "ssm": state.to(cache["ssm"].dtype)}


def ssm_cache_init(B: int, cfg, dtype=torch.float32, device=None) -> dict:
    """A zeroed cache of one layer for `B` sequences."""
    h, hp, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                   cfg.ssm_ngroups)
    conv, di = cfg.ssm_conv, cfg.ssm_d_inner

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"conv_x": zeros(B, conv - 1, di),
            "conv_B": zeros(B, conv - 1, g * n),
            "conv_C": zeros(B, conv - 1, g * n),
            "ssm": zeros(B, h, hp, n)}


def ssd_reference(x, dt, A, Bm, Cm, init_state=None):
    """The naive sequential recurrence, an oracle for the tests:
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t; y_t = C_t · h_t.
    Returns (y (B, S, H, P) fp32, final state (B, H, P, N) fp32)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    bh = Bm.float().repeat_interleave(rep, dim=2)
    ch = Cm.float().repeat_interleave(rep, dim=2)
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t].float() * A.float())       # (B, H)
        st = (da[..., None, None] * st
              + (dt[:, t, :, None].float() * x[:, t].float())[..., None]
              * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, ch[:, t]))
    return torch.stack(ys, dim=1), st
