"""The port's direct convolution against the JAX package, on the CPU.

`repro_torch.kernels.conv_direct.conv2d_direct` (on a CPU tensor its plain
version, the tap loop the kernel's arithmetic follows) against the JAX
`repro.kernels.conv_direct.conv2d_direct` in interpret mode, on the four
`CASES` of tests/test_kernels_conv.py (ragged bands, 1x1, an asymmetric
kernel, th > OH), fp32 at 1e-5 max-relative and bf16 at 5e-2; SAME
padding composed from padding outside plus the kernel against the port's
im2col `conv2d` on `eager`; the refusal under grad; and the contract the
JAX docstring names for a backend that registers the kernel: `conv2d`
left out of `differentiable`, so the engine's guard raises.  Inputs come
from numpy seeds.  The CUDA kernel runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.conv_direct import conv2d_direct as jax_conv2d_direct
from repro_torch.core import ComputeEngine, backends, make_engine
from repro_torch.kernels import conv_direct
from repro_torch.kernels.common import epilogue

torch.set_num_threads(1)

FP32_TOL = 1e-5
BF16_TOL = 5e-2
ENGINE = make_engine("eager", device="cpu")
CASES = [  # tests/test_kernels_conv.py: B, H, W, Cin, KH, KW, Cout, th
    (2, 16, 16, 3, 3, 3, 8, 7),     # OH=14, ragged bands (7x2)
    (1, 10, 12, 4, 1, 1, 16, 8),    # 1x1 conv
    (2, 12, 9, 2, 5, 3, 4, 4),      # asymmetric kernel
    (1, 9, 9, 8, 3, 3, 8, 8),       # th > OH (clamped)
]
DTYPES = [(jnp.float32, torch.float32, FP32_TOL),
          (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _operands(b, h, w, cin, kh, kw, cout, seed=0):
    rng = np.random.default_rng(seed + h * 7 + kh)
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (rng.standard_normal((kh, kw, cin, cout)) * 0.2).astype(
                np.float32))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("b,h,w_,cin,kh,kw,cout,th", CASES)
def test_conv_direct_matches_the_jax_kernel(b, h, w_, cin, kh, kw, cout, th,
                                            jdt, tdt, tol):
    x, w = _operands(b, h, w_, cin, kh, kw, cout)
    want = jax_conv2d_direct(jnp.asarray(x).astype(jdt),
                             jnp.asarray(w).astype(jdt), th=th,
                             interpret=True)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = conv_direct.conv2d_direct(tx, tw, th=th)
    assert tuple(got.shape) == want.shape == (b, h - kh + 1, w_ - kw + 1,
                                              cout)
    assert got.dtype == tdt
    assert torch.equal(got, conv_direct.conv2d_direct_plain(tx, tw))
    assert _relmax(got.float().numpy(),
                   np.asarray(want.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("tdt,tol", [(torch.float32, FP32_TOL),
                                     (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("size", [1, 3])
def test_same_padding_composes_to_the_im2col_conv(size, tdt, tol):
    """'SAME' conv = padding outside + the VALID kernel, as a Darknet layer
    would use it: against the engine's im2col conv2d (linear, no scale or
    shift), in which the weight is the flattened HWIO (kh*kw*Cin, Cout)."""
    pad = size // 2
    x, w = _operands(2, 8, 8, 3, size, size, 6, seed=1)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = conv_direct.conv2d_direct(
        F.pad(tx, (0, 0, pad, pad, pad, pad)), tw, th=8)
    eng = make_engine("eager", "mixed" if tdt == torch.bfloat16
                      else "fp32_strict", device="cpu")
    want = eng.conv2d(tx, tw.reshape(-1, 6), size=size, pad=pad,
                      out_dtype=tdt)
    assert got.shape == want.shape == (2, 8, 8, 6)
    assert _relmax(got.float().numpy(), want.float().numpy()) <= tol


def test_a_call_that_needs_a_gradient_raises():
    x, w = (torch.from_numpy(a) for a in _operands(1, 6, 6, 2, 3, 3, 4))
    with pytest.raises(NotImplementedError, match="forward only"):
        conv_direct.conv2d_direct(x.requires_grad_(), w)
    with pytest.raises(NotImplementedError, match="forward only"):
        conv_direct.conv2d_direct(x.detach(), w.requires_grad_())
    with torch.no_grad():                     # no graph: allowed
        assert conv_direct.conv2d_direct(x, w).shape == (1, 4, 4, 4)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x, w = (torch.from_numpy(a) for a in _operands(1, 6, 6, 2, 3, 3, 4))
    with pytest.raises(ValueError, match="need x"):
        conv_direct.conv2d_direct(x[0], w)
    with pytest.raises(ValueError, match="need x"):
        conv_direct.conv2d_direct(x, w[:, :, :1])            # Cin differs
    with pytest.raises(ValueError, match="does not fit"):
        conv_direct.conv2d_direct(x[:, :2], w)
    with pytest.raises(TypeError, match="share"):
        conv_direct.conv2d_direct(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="th must be"):
        conv_direct.conv2d_direct(x, w, th=0)
    big = torch.zeros(1, 70, 3, 1)
    with pytest.raises(ValueError, match="th must be"):
        conv_direct.conv2d_direct(big, torch.zeros(1, 1, 1, 1), th=65)
    assert conv_direct.conv2d_direct(big, torch.zeros(1, 1, 1, 1),
                                     th=64).shape == (1, 70, 3, 1)
    assert conv_direct.smem_bytes(8, 3, 3) == (10 * 10 * 8 + 9 * 8 * 64) * 4


def test_no_built_in_backend_registers_it():
    """As in the JAX package: every built-in `conv2d` is the im2col GEMM."""
    for name in ("ref", "eager", "cuda"):
        assert backends.get_backend(name).supports_grad("conv2d")


def _direct_conv2d(x, w, scale, shift, *, size, stride, pad, act,
                   out_dtype, ctx):
    """A `conv2d` op on the direct kernel: pad outside, stride 1, the
    flattened HWIO weight viewed as (KH, KW, Cin, Cout), the epilogue in
    fp32 as the fused GEMM's."""
    if stride != 1:
        raise NotImplementedError("the direct kernel is stride 1")
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    y = conv_direct.conv2d_direct(xp, w.reshape(size, size, x.shape[-1], -1))
    return epilogue(y.float(), scale, shift, act).to(out_dtype)


def test_a_backend_registering_it_leaves_conv2d_out_of_differentiable():
    """The contract of the JAX docstring: a backend whose conv2d is this
    kernel declares it not differentiable, so the engine's guard raises
    its capability error, naming the backend and the op, before the
    kernel is reached; without grad it serves the Darknet layer."""
    backends.register_backend("direct_conv", {"conv2d": _direct_conv2d},
                              differentiable=(), overwrite=True)
    try:
        eng = ComputeEngine(backend="direct_conv", device=torch.device("cpu"))
        x, w = (torch.from_numpy(a) for a in _operands(2, 8, 8, 3, 3, 3, 6))
        scale, shift = torch.rand(6) + 0.5, torch.randn(6) * 0.1
        kw = dict(scale=scale, shift=shift, size=3, pad=1, act="leaky")
        got = eng.conv2d(x, w.reshape(-1, 6), **kw)
        want = ENGINE.conv2d(x, w.reshape(-1, 6), **kw)
        assert _relmax(got.numpy(), want.numpy()) <= FP32_TOL
        with pytest.raises(NotImplementedError,
                           match="'conv2d' on backend 'direct_conv' is not "
                                 "differentiable"):
            eng.conv2d(x.requires_grad_(), w.reshape(-1, 6), **kw)
    finally:
        backends._REGISTRY.pop("direct_conv", None)
