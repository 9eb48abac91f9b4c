"""Shared pieces for the compute-engine kernels (PyTorch port of
``repro/kernels/common.py``).

The paper's HLS engine fuses the activation stage into the streaming GEMM
pipeline; the port's kernel does the same on the output tile in registers:

    y = act(acc * scale + shift)

``scale``/``shift`` are per-output-column vectors.  This one form covers all
Darknet layer needs: plain bias (scale=1, shift=bias), folded batch-norm
(scale=gamma/sqrt(var+eps), shift=beta-mean*scale [+bias]), and bare GEMM
(scale=None, shift=None).  The formulas here are the ones the CUDA kernel's
epilogue implements and the ones its plain version runs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Darknet's default conv activation is leaky ReLU with slope 0.1; LM blocks
# use silu/gelu.
_LEAKY_SLOPE = 0.1
_GELU_C = math.sqrt(2.0 / math.pi)

ACTIVATIONS = ("linear", "relu", "leaky", "silu", "gelu")


def apply_act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "linear":
        return x
    if act == "relu":
        # `where`, not clamp: the subgradient at exactly 0 is 0, matching
        # `act_deriv`.
        return torch.where(x > 0, x, 0.0)
    if act == "leaky":
        return torch.where(x > 0, x, _LEAKY_SLOPE * x)
    if act == "silu":
        return x * torch.sigmoid(x)
    if act == "gelu":
        # tanh approximation, as jax.nn.gelu(approximate=True)
        return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x**3)))
    raise ValueError(f"unknown activation: {act!r}")


def act_deriv(x: torch.Tensor, act: str) -> torch.Tensor:
    """d act(x) / dx, elementwise: the `act'(pre-act)` residual a training
    forward emits.  Subgradients at the relu/leaky kink follow `apply_act`'s
    `where` branches (0 resp. slope at exactly 0)."""
    if act == "linear":
        return torch.ones_like(x)
    if act == "relu":
        return torch.where(x > 0, 1.0, 0.0).to(x.dtype)
    if act == "leaky":
        return torch.where(x > 0, 1.0, _LEAKY_SLOPE).to(x.dtype)
    if act == "silu":
        s = 1.0 / (1.0 + torch.exp(-x))
        return s * (1.0 + x * (1.0 - s))
    if act == "gelu":
        t = torch.tanh(_GELU_C * (x + 0.044715 * x**3))
        return (0.5 * (1.0 + t)
                + 0.5 * x * (1.0 - t**2) * _GELU_C
                * (1.0 + 3 * 0.044715 * x**2))
    raise ValueError(f"unknown activation: {act!r}")


def epilogue(acc, scale, shift, act: str):
    """acc: (M, N) fp32; scale/shift: (N,) or None."""
    y = acc
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    return apply_act(y, act)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int
           ) -> torch.Tensor:
    """x: (B, H, W, C) -> patches (B, OH, OW, kh*kw*C).

    The canonical Darknet conv lowering: materialize patches, GEMM on the
    engine.  Feature order is (kh, kw, C), matching the flattened HWIO
    weight layout.  The patches are built in that order directly, one
    strided slice of the zero-padded input per (ki, kj) tap, so no
    channel-major reorder is needed (``F.unfold`` would give (C, kh, kw)).
    Differentiable through `Im2col`, whose backward is `col2im`.
    """
    return Im2col.apply(x, kh, kw, stride, pad)


class Im2col(torch.autograd.Function):
    """`im2col` with the JAX package's custom VJP: the backward scatters
    the patch cotangents back with `col2im` (taps summed in fp32 into one
    buffer) and casts to the input's dtype.  Autograd through the ``cat``
    of tap slices would give the same numbers with one padded zero tensor
    per tap."""

    @staticmethod
    def forward(ctx, x, kh, kw, stride, pad):
        ctx.geometry = (tuple(x.shape), x.dtype, kh, kw, stride, pad)
        return _im2col(x, kh, kw, stride, pad)

    @staticmethod
    def backward(ctx, g):
        x_shape, dtype, kh, kw, stride, pad = ctx.geometry
        dx = col2im(g, x_shape, kh, kw, stride, pad).to(dtype)
        return dx, None, None, None, None


def _im2col(x, kh, kw, stride, pad):
    b, h, w, _ = x.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w + 2 * pad - kw) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    taps = [xp[:, ki:ki + (oh - 1) * stride + 1:stride,
               kj:kj + (ow - 1) * stride + 1:stride, :]
            for ki in range(kh) for kj in range(kw)]
    return taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)


def col2im(g: torch.Tensor, x_shape: tuple, kh: int, kw: int, stride: int,
           pad: int) -> torch.Tensor:
    """Transpose of `im2col`: scatter patch values g (B, OH, OW, kh*kw*C)
    back onto (B, H, W, C) in fp32.  Loop over the (kh, kw) taps, each a
    strided slice-add: output position (i, j) of tap (ki, kj) read padded
    input position (i*stride + ki, j*stride + kj)."""
    b, h, w, c = x_shape
    _, oh, ow, _ = g.shape
    g = g.reshape(b, oh, ow, kh, kw, c).float()
    dx = torch.zeros((b, h + 2 * pad, w + 2 * pad, c), dtype=torch.float32,
                     device=g.device)
    for ki in range(kh):
        for kj in range(kw):
            dx[:, ki:ki + oh * stride:stride,
               kj:kj + ow * stride:stride, :] += g[:, :, :, ki, kj]
    return dx[:, pad:pad + h, pad:pad + w, :]
