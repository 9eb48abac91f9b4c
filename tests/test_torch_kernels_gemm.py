"""The port's fused GEMM against the JAX package's Pallas kernel.

On the CPU the port's kernel wrapper runs its plain version; the JAX side
runs `repro.kernels.ops.matmul` in Pallas interpret mode, as
tests/test_kernels_gemm.py does.  Inputs are made once with numpy and handed
to both.  fp32 is held to 1e-5 max-relative, bf16 to 5e-2 (the bars of
tests/test_grad_conformance.py).  The CUDA kernel itself runs only on the
card: chip_smoke.py holds it against the same plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import build, gemm, ops, ref
from repro_torch.kernels.common import ACTIVATIONS

torch.set_num_threads(1)

# The grids and bars of tests/test_grad_conformance.py.
MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99)]
BMM_CASES = [(2, 32, 16, 32), (3, 17, 23, 9)]
FP32_TOL = 1e-5
BF16_TOL = 5e-2
EPILOGUES = ("none", "scale", "shift", "both")


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _operands(m, k, n, epi):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = rng.normal(0.0, 0.5, n).astype(np.float32)
    return (x, w, scale if epi in ("scale", "both") else None,
            shift if epi in ("shift", "both") else None)


def _jnp(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _tt(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _both(m, k, n, act, epi, jdt, tdt):
    x, w, scale, shift = _operands(m, k, n, epi)
    want = jax_ops.matmul(_jnp(x, jdt), _jnp(w, jdt), _jnp(scale),
                          _jnp(shift), act=act, interpret=True)
    got = ops.matmul(_tt(x, tdt), _tt(w, tdt), _tt(scale), _tt(shift),
                     act=act)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_matmul_fp32_matches_jax_kernel(m, k, n, act, epi):
    got, want = _both(m, k, n, act, epi, jnp.float32, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    rel = _relmax(got.numpy(), want)
    assert rel <= FP32_TOL, f"rel err {rel:.2e} > {FP32_TOL:g}"


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_matmul_bf16_matches_jax_kernel(m, k, n, act, epi):
    got, want = _both(m, k, n, act, epi, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rel = _relmax(got.float().numpy(), want)
    assert rel <= BF16_TOL, f"rel err {rel:.2e} > {BF16_TOL:g}"


@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_matmul_ref_matches_jax_ref(m, k, n):
    x, w, scale, shift = _operands(m, k, n, "both")
    want = jax_ref.matmul_ref(_jnp(x), _jnp(w), scale=_jnp(scale),
                              shift=_jnp(shift), act="leaky")
    got = ref.matmul_ref(_tt(x), _tt(w), scale=_tt(scale), shift=_tt(shift),
                         act="leaky")
    assert _relmax(got.numpy(), np.asarray(want)) <= FP32_TOL


@pytest.mark.parametrize("b,m,k,n", BMM_CASES)
def test_bmm_ref_matches_jax_ref(b, m, k, n):
    rng = np.random.default_rng(b * 97 + m)
    x = rng.standard_normal((b, m, k)).astype(np.float32)
    w = rng.standard_normal((b, k, n)).astype(np.float32)
    want = jax_ref.bmm_ref(jnp.asarray(x), jnp.asarray(w))
    got = ref.bmm_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert _relmax(got.numpy(), np.asarray(want)) <= FP32_TOL


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    x, w, scale, shift = _operands(33, 177, 99, "both")
    before = gemm.launches
    got = gemm.gemm_fused_fwd(_tt(x), _tt(w), _tt(scale), _tt(shift),
                              act="gelu")
    want = gemm.gemm_fused_plain(_tt(x), _tt(w), _tt(scale), _tt(shift),
                                 act="gelu")
    assert torch.equal(got, want)
    assert gemm.launches == before  # the count moves only on a launch
    assert not build._LIBS          # and nothing was built or loaded


def test_matmul_out_dtype_and_any_shape():
    x, w, _, shift = _operands(1, 27, 1000, "shift")
    y = ops.matmul(_tt(x), _tt(w), None, _tt(shift), act="relu",
                   out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 1000)
    want = ref.matmul_ref(_tt(x), _tt(w), shift=_tt(shift), act="relu",
                          out_dtype=torch.bfloat16)
    assert torch.equal(y, want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "act", "scale", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 3)
    kw = {}
    if bad == "shape":
        w = torch.zeros(7, 3)
    elif bad == "dtype":
        w = w.double()
    elif bad == "act":
        kw["act"] = "swish"
    elif bad == "scale":
        kw["scale"] = torch.zeros(4)
    elif bad == "device":  # neither CPU nor CUDA: raise, never fall back
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises((ValueError, TypeError)):
        gemm.gemm_fused_fwd(x, w, **kw)


@pytest.mark.parametrize("m,k,n", MATMUL_CASES + [
    (401408, 27, 32), (100352, 288, 64), (1568, 2304, 512), (1, 512, 1000)])
def test_default_tiles_are_instantiated_tiles(m, k, n):
    plan = ops.default_tiles(m, k, n)
    assert plan in gemm.PLANS and (plan.regime == "A") == (m <= 64)


def test_library_path_is_keyed_by_source_hash_under_build():
    p = build.library_path("gemm")
    assert p == build.library_path("gemm")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libgemm-")
    assert p.parent.name == "build"
    assert (build.CSRC / "gemm.cu").is_file()
