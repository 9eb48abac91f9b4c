"""The port's backward GEMMs and residual forward against the JAX package's
Pallas kernels, on the CPU.

On the CPU the port's wrappers run their plain versions; the JAX side runs
`repro.kernels.gemm.gemm_bwd_dx` / `gemm_bwd_dw` and
`_gemm_forward(..., residuals=True)` in Pallas interpret mode, on shapes its
BlockSpecs divide.  Inputs are made once with numpy and handed to both.
fp32 is held to 1e-5 max-relative, bf16 to 5e-2 (the bars of
tests/test_grad_conformance.py).  The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py and chip_smoke.py hold them against the
same plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as jax_gemm
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.common import ACTIVATIONS

torch.set_num_threads(1)

FP32_TOL = 1e-5
BF16_TOL = 5e-2
# (M, K, N) with the (bm, bk, bn) of the JAX kernels' backward problems.
BWD_CASES = [(64, 48, 32, 16), (32, 128, 256, 32), (96, 32, 80, 16)]
DTYPES = [(jnp.float32, torch.float32, FP32_TOL),
          (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("m,k,n,blk", BWD_CASES)
def test_dx_plain_matches_jax_kernel(m, k, n, blk, jdt, tdt, tol):
    dy, w = _arrays(m + k + n, (m, n), (k, n))
    want = jax_gemm.gemm_bwd_dx(jnp.asarray(dy).astype(jdt),
                                jnp.asarray(w).astype(jdt), bm=blk, bk=blk,
                                bn=blk, out_dtype=jnp.float32, interpret=True)
    got = gemm.gemm_bwd_dx(torch.from_numpy(dy).to(tdt),
                           torch.from_numpy(w).to(tdt),
                           out_dtype=torch.float32)
    assert tuple(got.shape) == (m, k) and got.dtype == torch.float32
    assert _relmax(got.numpy(), _f32(want)) <= tol


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("m,k,n,blk", BWD_CASES)
def test_dw_plain_matches_jax_kernel(m, k, n, blk, jdt, tdt, tol):
    x, dy = _arrays(m * k + n, (m, k), (m, n))
    want = jax_gemm.gemm_bwd_dw(jnp.asarray(x).astype(jdt),
                                jnp.asarray(dy).astype(jdt), bm=blk, bk=blk,
                                bn=blk, interpret=True)
    got = gemm.gemm_bwd_dw(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(dy).to(tdt))
    assert tuple(got.shape) == (k, n) and got.dtype == tdt
    assert _relmax(got.float().numpy(), _f32(want)) <= tol


@pytest.mark.parametrize("epi", ["none", "scale", "shift", "both"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_residual_plain_matches_jax_kernel(act, epi):
    """g = act'(u) where an activation is fused, racc = x @ w where a
    scale is: the same outputs, present in the same cases."""
    m, k, n = 32, 48, 64
    x, w = _arrays(7, (m, k), (k, n))
    w /= np.sqrt(k)
    rng = np.random.default_rng(8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = rng.normal(0.0, 0.5, n).astype(np.float32)
    scale = scale if epi in ("scale", "both") else None
    shift = shift if epi in ("shift", "both") else None
    cfg = jax_gemm._Config(act=act, out_dtype="float32", bm=16, bk=16, bn=32,
                           has_scale=scale is not None,
                           has_shift=shift is not None, interpret=True)
    want = jax_gemm._gemm_forward(
        cfg, jnp.asarray(x), jnp.asarray(w),
        None if scale is None else jnp.asarray(scale).reshape(1, n),
        None if shift is None else jnp.asarray(shift).reshape(1, n),
        residuals=True)
    got = gemm.gemm_fused_fwd(
        torch.from_numpy(x), torch.from_numpy(w),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), act=act,
        residuals=True)
    for name, a, b in zip(("y", "g", "racc"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.float32 and tuple(a.shape) == (m, n)
            assert _relmax(a.numpy(), np.asarray(b)) <= FP32_TOL, name


def test_residual_forward_y_equals_the_serving_forward():
    x, w = _arrays(3, (33, 27), (27, 40))
    shift = torch.linspace(-1, 1, 40)
    args = (torch.from_numpy(x), torch.from_numpy(w), None, shift)
    y, g, racc = gemm.gemm_fused_fwd(*args, act="leaky", residuals=True)
    assert torch.equal(y, gemm.gemm_fused_fwd(*args, act="leaky"))
    assert racc is None
    assert set(g.unique().tolist()) <= {np.float32(0.1).item(), 1.0}


def test_leaky_and_relu_derivative_at_exactly_zero():
    """The kink follows `apply_act`'s `where`: relu' = 0, leaky' = 0.1."""
    x = torch.eye(4)
    w = torch.tensor([[1.0, -1.0, 0.0, 2.0]] * 4).t().contiguous()
    for act, at_zero in (("relu", 0.0), ("leaky", 0.1)):
        y, g, _ = gemm.gemm_fused_fwd(x, w, act=act, residuals=True)
        u = x @ w
        assert (g[u == 0] == at_zero).all() and (g[u > 0] == 1).all()


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "out_dtype",
                                 "device"])
@pytest.mark.parametrize("variant", ["dx", "dw"])
def test_bwd_wrappers_refuse_what_the_kernel_does_not_take(variant, bad):
    a, b = torch.zeros(6, 4), torch.zeros(6, 5)  # dw: x (M, K), dy (M, N)
    if variant == "dx":
        a, b = torch.zeros(6, 5), torch.zeros(4, 5)  # dy (M, N), w (K, N)
    kw = {}
    if bad == "shape":
        b = b[:, :3] if variant == "dx" else b[:5]
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif bad == "device":  # neither CPU nor CUDA: raise, never fall back
        a, b = a.to("meta"), b.to("meta")
    fn = gemm.gemm_bwd_dx if variant == "dx" else gemm.gemm_bwd_dw
    with pytest.raises((ValueError, TypeError)):
        fn(a, b, **kw)


def test_cpu_bwd_wrappers_accept_any_layout_and_launch_nothing():
    """Contiguity binds only the kernel (tests/test_torch_cuda.py); the
    plain version takes a transposed view."""
    dy, w = _arrays(11, (9, 7), (7, 5))
    before = gemm.launch_counts()
    got = gemm.gemm_bwd_dx(torch.from_numpy(dy),
                           torch.from_numpy(w).t(), splits=3)
    np.testing.assert_allclose(got.numpy(), dy @ w, rtol=1e-6, atol=1e-6)
    assert gemm.launch_counts() == before


@pytest.mark.parametrize("kdim,splits", [(0, 1), (1, 4), (401408, 784),
                                         (100, 3), (1568, 2), (17, 100)])
def test_split_chunk_covers_the_contraction_in_whole_stages(kdim, splits):
    chunk, s = gemm.split_chunk(kdim, splits)
    assert chunk % gemm.BK == 0 and 1 <= s <= max(1, splits)
    assert (s - 1) * chunk < max(kdim, 1) <= s * chunk


# The DARKNET19_CFG GEMMs at batch 8: (M, K, N).
DARKNET19_B8 = [(401408, 27, 32), (100352, 288, 64), (25088, 576, 128),
                (25088, 128, 64), (25088, 576, 128), (6272, 1152, 256),
                (6272, 256, 128), (6272, 1152, 256), (1568, 2304, 512),
                (1568, 512, 256), (1568, 2304, 512), (8, 512, 1000)]


@pytest.mark.parametrize("m,k,n", DARKNET19_B8)
def test_default_bwd_tiles_split_small_outputs_only(m, k, n):
    for variant, dims in (("dx", (m, n, k)), ("dw", (k, m, n))):
        bm, bk, bn, splits = ops.default_bwd_tiles(variant, *dims)
        assert bm == bn == ops._bwd_tile(dims[0], dims[2])
        assert bm in gemm.TILES and bk == gemm.BK
        assert ops.default_bwd_tiles(variant, *dims)[3] == splits
        rows, kdim, cols = dims
        if splits > 1:
            assert kdim // splits >= ops._MIN_SPLIT_DEPTH
        blocks = -(-rows // bm) * -(-cols // bn)
        if blocks * (bm // 4) ** 2 >= ops._SPLIT_THREADS:
            assert splits == 1
    # The first layer's dW is one 32 x 32 tile over 401,408 rows.
    if (m, k) == (401408, 27):
        assert ops.default_bwd_tiles("dw", k, m, n)[3] > 100
    with pytest.raises(ValueError, match="variant"):
        ops.default_bwd_tiles("bdx", m, n, k)
