"""Darknet layer library, lowered onto the compute engine (PyTorch port of
``repro/core/darknet/layers.py``).

All tensors are NHWC.  Convolution follows Darknet's canonical
decomposition: im2col -> GEMM on the engine -> reshape, with batch-norm
folded into the engine's fused (scale, shift) epilogue so a
conv+BN+activation layer is ONE engine invocation: the paper's
stream-fused pipeline.

Deconvolution (transpose conv) is GEMM + col2im, same engine.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.engine import ComputeEngine
from repro_torch.kernels.common import apply_act, col2im
from repro_torch.scopes import span

_BN_EPS = 1e-5


def fold_batchnorm(gamma, beta, mean, var, bias=None):
    """Returns (scale, shift) for the engine epilogue: y = conv*scale+shift."""
    scale = gamma / torch.sqrt(var + _BN_EPS)
    shift = beta - mean * scale
    if bias is not None:
        shift = shift + bias * scale
    return scale, shift


def _epilogue_params(params, batch_normalize: bool):
    if batch_normalize:
        with span("darknet.fold"):
            return fold_batchnorm(params["gamma"], params["beta"],
                                  params["mean"], params["var"])
    return None, params.get("b")


# ----------------------------------------------------------------- layers ---

def conv2d(engine: ComputeEngine, params, x, *, size: int, stride: int,
           pad: int, act: str, batch_normalize: bool):
    """Darknet [convolutional]: ONE fused engine conv2d op."""
    scale, shift = _epilogue_params(params, batch_normalize)
    return engine.conv2d(x, params["w"], scale=scale, shift=shift,
                         size=size, stride=stride, pad=pad, act=act,
                         out_dtype=x.dtype)


def deconv2d(engine: ComputeEngine, params, x, *, size: int, stride: int,
             pad: int, act: str, batch_normalize: bool):
    """Darknet [deconvolutional]: engine GEMM + col2im (scatter-add).

    x: (B, H, W, Cin); w: (Cin, kh*kw*Cout).  Output spatial size follows
    conv_transpose: OH = (H-1)*stride + size - 2*pad.
    """
    w = params["w"]
    b, h, wd, cin = x.shape
    cout = w.shape[1] // (size * size)
    cols = engine.matmul(x.reshape(b * h * wd, cin), w,
                         out_dtype=torch.float32)
    oh = (h - 1) * stride + size - 2 * pad
    ow = (wd - 1) * stride + size - 2 * pad
    out = col2im(cols.reshape(b, h, wd, -1), (b, oh, ow, cout), size, size,
                 stride, pad)
    scale, shift = _epilogue_params(params, batch_normalize)
    if scale is not None:
        out = out * scale
    if shift is not None:
        out = out + shift
    return apply_act(out, act).to(x.dtype)


def maxpool(x, *, size: int, stride: int, pad: int = 0):
    """NHWC max pool: `pad` cells of -inf on every side, then VALID
    windows (as the JAX layer; see ROADMAP Queue 3 on padding > 0)."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory
    if pad:
        xc = F.pad(xc, (pad, pad, pad, pad), value=-math.inf)
    return F.max_pool2d(xc, size, stride).permute(0, 2, 3, 1)


def avgpool_global(x):
    return x.mean(dim=(1, 2))  # darknet [avgpool] is global


def upsample(x, *, stride: int):
    return x.repeat_interleave(stride, dim=1).repeat_interleave(stride,
                                                                dim=2)


def shortcut(x, other, *, act: str = "linear"):
    return apply_act(x + other, act)


def route(tensors):
    return torch.cat(tensors, dim=-1)


def connected(engine: ComputeEngine, params, x, *, act: str):
    """Darknet [connected]; the input flattens in (h, w, c) order."""
    b = x.shape[0]
    return engine.matmul(x.reshape(b, -1), params["w"], shift=params["b"],
                         act=act, out_dtype=x.dtype)


def softmax(x):
    return torch.softmax(x, dim=-1)


# ------------------------------------------------------------------- init ---

def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _bn_or_bias(cout, batch_normalize):
    if batch_normalize:
        return {"gamma": torch.ones(cout), "beta": torch.zeros(cout),
                "mean": torch.zeros(cout), "var": torch.ones(cout)}
    return {"b": torch.zeros(cout)}


def init_conv(gen: torch.Generator, size, cin, cout, batch_normalize):
    """He-normal (kh*kw*Cin, Cout) weight; BN 1/0/0/1 or a zero bias.
    Tensors are fp32 on the CPU (where `gen` draws)."""
    fan_in = size * size * cin
    p = {"w": _normal(gen, (fan_in, cout), math.sqrt(2.0 / fan_in))}
    p.update(_bn_or_bias(cout, batch_normalize))
    return p


def init_deconv(gen: torch.Generator, size, cin, cout, batch_normalize):
    p = {"w": _normal(gen, (cin, size * size * cout), math.sqrt(2.0 / cin))}
    p.update(_bn_or_bias(cout, batch_normalize))
    return p


def init_connected(gen: torch.Generator, nin, nout):
    return {"w": _normal(gen, (nin, nout), math.sqrt(2.0 / nin)),
            "b": torch.zeros(nout)}
