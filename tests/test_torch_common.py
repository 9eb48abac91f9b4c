"""The port's shared kernel glue against the JAX package's.

`apply_act`, `act_deriv`, `epilogue`, `im2col` and `col2im` of
`repro_torch.kernels.common` are held against `repro.kernels.common` on the
same numpy inputs, over the `CONV_CASES` grid of
tests/test_grad_conformance.py.  fp32 throughout; the bar is 1e-5
max-relative (im2col only moves values, so it must agree exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jax_common
from repro_torch.kernels import common

torch.set_num_threads(1)

# (B, H, W, Cin, Cout, size, stride, pad): the darknet_ref layer zoo of
# tests/test_grad_conformance.py.
CONV_CASES = [
    (2, 28, 28, 3, 16, 3, 1, 1),
    (2, 14, 14, 16, 32, 3, 1, 1),
    (2, 7, 7, 32, 64, 3, 1, 1),
    (1, 9, 11, 5, 7, 3, 2, 1),
]
FP32_TOL = 1e-5


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _points(seed=0) -> np.ndarray:
    """Activation inputs over [-6, 6], with exact zeros at the kinks."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-6.0, 6.0, (64, 33)).astype(np.float32)
    x[0, :5] = 0.0
    return x


@pytest.mark.parametrize("act", common.ACTIVATIONS)
def test_apply_act_matches_jax(act):
    x = _points()
    want = np.asarray(jax_common.apply_act(jnp.asarray(x), act))
    got = common.apply_act(torch.from_numpy(x), act).numpy()
    assert got.dtype == np.float32
    assert _relmax(got, want) <= FP32_TOL
    if act in ("relu", "leaky"):  # where-based: exact, 0 maps to 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("act", common.ACTIVATIONS)
def test_act_deriv_matches_jax(act):
    x = _points(1)
    want = np.asarray(jax_common.act_deriv(jnp.asarray(x), act))
    got = common.act_deriv(torch.from_numpy(x), act).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    assert _relmax(got, want) <= FP32_TOL
    if act in ("linear", "relu", "leaky"):  # subgradient at 0 included
        np.testing.assert_array_equal(got, want)


def test_activation_names_and_unknown_activation():
    assert common.ACTIVATIONS == jax_common.ACTIVATIONS
    with pytest.raises(ValueError):
        common.apply_act(torch.zeros(2), "swish")
    with pytest.raises(ValueError):
        common.act_deriv(torch.zeros(2), "swish")


@pytest.mark.parametrize("epi", ["none", "scale", "shift", "both"])
@pytest.mark.parametrize("act", common.ACTIVATIONS)
def test_epilogue_matches_jax(act, epi):
    rng = np.random.default_rng(7)
    acc = rng.standard_normal((17, 9)).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, 9).astype(np.float32)
             if epi in ("scale", "both") else None)
    shift = (rng.normal(0.0, 0.5, 9).astype(np.float32)
             if epi in ("shift", "both") else None)
    want = jax_common.epilogue(
        jnp.asarray(acc), None if scale is None else jnp.asarray(scale)[None],
        None if shift is None else jnp.asarray(shift)[None], act)
    got = common.epilogue(
        torch.from_numpy(acc),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), act)
    assert _relmax(got.numpy(), np.asarray(want)) <= FP32_TOL


@pytest.mark.parametrize("b,h,w,cin,cout,size,stride,pad", CONV_CASES)
def test_im2col_matches_jax_exactly(b, h, w, cin, cout, size, stride, pad):
    rng = np.random.default_rng(h * 100 + cin)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    want = np.asarray(jax_common.im2col(jnp.asarray(x), size, size, stride,
                                        pad))
    got = common.im2col(torch.from_numpy(x), size, size, stride, pad)
    assert tuple(got.shape) == want.shape
    # (kh, kw, C) feature order: values are moved, never summed.
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,stride,pad", [(1, 1, 0), (2, 2, 0), (3, 2, 0)])
def test_im2col_matches_jax_on_other_geometries(size, stride, pad):
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((2, 8, 7, 4)).astype(np.float32)
    want = np.asarray(jax_common.im2col(jnp.asarray(x), size, size, stride,
                                        pad))
    got = common.im2col(torch.from_numpy(x), size, size, stride, pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,h,w,cin,cout,size,stride,pad", CONV_CASES)
def test_col2im_matches_jax(b, h, w, cin, cout, size, stride, pad):
    oh = (h + 2 * pad - size) // stride + 1
    ow = (w + 2 * pad - size) // stride + 1
    rng = np.random.default_rng(w * 100 + cout)
    g = rng.standard_normal((b, oh, ow, size * size * cin)).astype(np.float32)
    want = np.asarray(jax_common.col2im(jnp.asarray(g), (b, h, w, cin), size,
                                        size, stride, pad))
    got = common.col2im(torch.from_numpy(g), (b, h, w, cin), size, size,
                        stride, pad)
    assert tuple(got.shape) == (b, h, w, cin) and got.dtype == torch.float32
    assert _relmax(got.numpy(), want) <= FP32_TOL


def test_col2im_is_the_transpose_of_im2col():
    """<im2col(x), g> == <x, col2im(g)> for random x and g."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 9, 11, 5)).astype(np.float32))
    cols = common.im2col(x, 3, 3, 2, 1)
    g = torch.from_numpy(rng.standard_normal(tuple(cols.shape))
                         .astype(np.float32))
    lhs = float((cols.double() * g.double()).sum())
    rhs = float((x.double() * common.col2im(g, tuple(x.shape), 3, 3, 2, 1)
                 .double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))
