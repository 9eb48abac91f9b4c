"""The port's batched GEMM (the engine `bmm` op) against the JAX package, on
the CPU.

The engine op on `ref` and `eager`, and `kernels.ops.bmm` (through
`gemm.BmmFn`, whose kernel wrappers run their plain versions on a CPU
tensor), against the JAX engine's `pallas` backend (the Pallas kernels in
interpret mode, padded by its wrapper) and `xla`: the forward and the
gradients of sum(bmm(x, w)**2) by autograd and by `jax.grad`, on the
`BMM_CASES` of tests/test_grad_conformance.py, fp32 under `fp32_strict`
at 1e-5 max-relative and bf16 operands under `mixed` at 5e-2.  The three
plain versions against `repro.kernels.gemm.bmm` / `bmm_bwd_dx` /
`bmm_bwd_dw` in interpret mode; the wrappers' checks; the backward plan;
the dispatch counts.  Inputs are made with numpy from a seed and handed to
both packages.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jax_make_engine
from repro.kernels import gemm as jax_gemm
from repro_torch.core import backends, make_engine
from repro_torch.kernels import gemm, ops

torch.set_num_threads(1)

FP32_TOL = 1e-5
BF16_TOL = 5e-2
BMM_CASES = [(2, 32, 16, 32), (3, 17, 23, 9)]   # test_grad_conformance.py
POLICIES = [("fp32_strict", jnp.float32, torch.float32, FP32_TOL),
            ("mixed", jnp.bfloat16, torch.bfloat16, BF16_TOL)]


def _relmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _operands(b, m, k, n):
    rng = np.random.default_rng(b * 100 + m + n)
    return (rng.standard_normal((b, m, k)).astype(np.float32),
            (rng.standard_normal((b, k, n)) * 0.3).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_run(backend, policy, case):
    """The JAX engine's forward and jax.grad of sum(bmm**2), as fp32
    numpy arrays."""
    jdt = dict((p, j) for p, j, _, _ in POLICIES)[policy]
    eng = jax_make_engine(backend, policy)
    x, w = (jnp.asarray(a).astype(jdt) for a in _operands(*case))

    def loss(x, w):
        return (eng.bmm(x, w).astype(jnp.float32) ** 2).sum()

    y = eng.bmm(x, w)
    dx, dw = jax.grad(loss, argnums=(0, 1))(x, w)
    return tuple(_f32(t) for t in (y, dx, dw))


def _port_run(how, policy, case):
    tdt = dict((p, t) for p, _, t, _ in POLICIES)[policy]
    x, w = (torch.from_numpy(a).to(tdt).requires_grad_()
            for a in _operands(*case))
    if how == "ops":
        y = ops.bmm(x, w)
    else:
        y = make_engine(how, policy, device="cpu").bmm(x, w)
    assert y.dtype == tdt and tuple(y.shape) == (case[0], case[1], case[3])
    dx, dw = torch.autograd.grad((y.float() ** 2).sum(), (x, w))
    assert dx.dtype == tdt and dw.dtype == tdt
    return tuple(_f32(t) for t in (y, dx, dw))


@pytest.mark.parametrize("policy,jdt,tdt,tol", POLICIES)
@pytest.mark.parametrize("case", BMM_CASES)
@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
@pytest.mark.parametrize("how", ["ref", "eager", "ops"])
def test_bmm_and_its_gradients_match_jax(how, jax_backend, case, policy, jdt,
                                         tdt, tol):
    """y, dL/dx and dL/dw of L = sum(bmm(x, w)**2): the engine op on `ref`
    and `eager`, and `ops.bmm` through `BmmFn` (the `cuda` op's path, its
    wrappers running their plain versions on the CPU)."""
    got = _port_run(how, policy, case)
    want = _jax_run(jax_backend, policy, case)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        assert a.shape == b.shape, name
        err = _relmax(a, b)
        assert err <= tol, f"{name}: {err:.3e} > {tol:g}"


# (B, M, K, N) that the JAX kernels' blocks divide, with that block.
KERNEL_CASES = [(2, 32, 48, 64, 16), (3, 16, 32, 16, 16)]
DTYPES = [(jnp.float32, torch.float32, FP32_TOL),
          (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("b,m,k,n,blk", KERNEL_CASES)
@pytest.mark.parametrize("kernel", ["fwd", "dx", "dw"])
def test_plain_versions_match_the_jax_kernels(kernel, b, m, k, n, blk, jdt,
                                              tdt, tol):
    """`bmm_fwd_plain`, `bmm_bwd_dx_plain`, `bmm_bwd_dw_plain` (which the
    wrappers run on the CPU) against the Pallas kernels in interpret
    mode, out in the first operand's dtype."""
    shapes = {"fwd": ((b, m, k), (b, k, n)), "dx": ((b, m, n), (b, k, n)),
              "dw": ((b, m, k), (b, m, n))}[kernel]
    a, c = _arrays(b * m + k * n, *shapes)
    ja, jc = jnp.asarray(a).astype(jdt), jnp.asarray(c).astype(jdt)
    if kernel == "fwd":
        want = jax_gemm.bmm(ja, jc, bm=blk, bk=blk, bn=blk, interpret=True)
        fn, plain = gemm.bmm_fwd, gemm.bmm_fwd_plain
    elif kernel == "dx":
        want = jax_gemm.bmm_bwd_dx(ja, jc, bm=blk, bk=blk, bn=blk,
                                   interpret=True)
        fn, plain = gemm.bmm_bwd_dx, gemm.bmm_bwd_dx_plain
    else:
        want = jax_gemm.bmm_bwd_dw(ja, jc, bm=blk, bk=blk, bn=blk,
                                   interpret=True)
        fn, plain = gemm.bmm_bwd_dw, gemm.bmm_bwd_dw_plain
    ta, tc = torch.from_numpy(a).to(tdt), torch.from_numpy(c).to(tdt)
    got = fn(ta, tc)
    assert torch.equal(got, plain(ta, tc))     # the CPU path is the plain one
    assert tuple(got.shape) == want.shape and got.dtype == tdt
    assert _relmax(_f32(got), _f32(want)) <= tol


@pytest.mark.parametrize("fn,a_shape,b_shape,cdim", [
    (gemm.bmm_fwd, (2, 4, 5), (2, 5, 3), 2),
    (gemm.bmm_bwd_dx, (2, 4, 3), (2, 5, 3), 2),
    (gemm.bmm_bwd_dw, (2, 4, 5), (2, 4, 3), 1)])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, a_shape, b_shape,
                                                      cdim):
    a, b = torch.zeros(a_shape), torch.zeros(b_shape)
    assert fn(a, b).dim() == 3
    with pytest.raises(ValueError, match="needs"):
        fn(a[0], b[0])                                   # 2-D
    with pytest.raises(ValueError, match="needs"):
        fn(a, b[:1])                                     # batches differ
    with pytest.raises(ValueError, match="needs"):
        fn(a.narrow(cdim, 0, a.shape[cdim] - 1), b)      # contraction
    with pytest.raises(TypeError, match="share"):
        fn(a, b.to(torch.bfloat16))
    with pytest.raises(TypeError, match="share"):
        fn(a.half(), b.half())
    with pytest.raises(TypeError, match="out_dtype"):
        fn(a, b, out_dtype=torch.float16)


def test_ops_and_engine_refuse_mismatched_operands():
    x, w = torch.zeros(2, 4, 5), torch.zeros(2, 6, 3)
    with pytest.raises(ValueError, match=r"\(B, M, K\)"):
        ops.bmm(x, w)
    for be in ("ref", "eager", "cuda"):
        eng = backends.get_backend(be)
        assert "bmm" in eng.ops and eng.supports_grad("bmm")
    with pytest.raises(ValueError, match=r"\(B, M, K\)"):
        make_engine("eager", device="cpu").bmm(x, w)
    with pytest.raises(ValueError, match=r"\(B, M, K\)"):
        make_engine("eager", device="cpu").bmm(x[0], w[0])


def test_cuda_bmm_refuses_a_cpu_tensor():
    """The `cuda` op never falls back to the CPU; its ssd-style
    inference-only hook does not claim bmm, which is differentiable."""
    be = backends.get_backend("cuda")
    x, w = torch.zeros(2, 4, 5), torch.zeros(2, 5, 3)
    ctx = backends.OpContext(precision=make_engine(
        "eager", device="cpu").precision, tiles=(32, 16, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        be.op("bmm")(x, w, out_dtype=torch.float32, ctx=ctx)
    assert not be.inference_only("bmm", (x, w))


@pytest.mark.parametrize("variant,rows,kdim,cols,split_at_2", [
    ("dx", 16, 4096, 16, True), ("dw", 16, 8192, 16, True),
    ("dx", 256, 8192, 5120, False), ("dw", 5120, 256, 8192, False)])
def test_backward_plan_counts_the_batch(variant, rows, kdim, cols,
                                        split_at_2):
    """The plan depends on the shape alone; a batch of B matrices splits
    the contraction no more than one matrix does (its output tiles fill
    the card B times over), and the grid's z extent (batch x splits) stays
    within 65,535.  A small output of a long contraction splits; the
    llama4-scout expert GEMMs (the last two) fill the card unsplit."""
    one = ops.default_bwd_tiles(variant, rows, kdim, cols)
    assert one == ops.default_bwd_tiles(variant, rows, kdim, cols, batch=1)
    prev = one[3]
    for b in (2, 16, 1000, 65535):
        plan = ops.default_bwd_tiles(variant, rows, kdim, cols, batch=b)
        assert plan[:3] == one[:3]
        assert 1 <= plan[3] <= prev and b * plan[3] <= gemm.MAX_GRID_Z
        assert plan == ops.default_bwd_tiles(variant, rows, kdim, cols,
                                             batch=b)
        prev = plan[3]
    two = ops.default_bwd_tiles(variant, rows, kdim, cols, batch=2)
    assert (two[3] > 1) == split_at_2


def test_dispatches_are_counted_per_call():
    """Every call counts (the JAX package counts per trace), and the log
    keeps the GEMM key (m, k, n) without the batch, as the JAX key."""
    backends.reset_dispatch_counts()
    eng = make_engine("eager", device="cpu")
    x, w = torch.randn(2, 8, 8), torch.randn(2, 8, 8)
    eng.matmul(x[0], w[0])
    eng.bmm(x, w)
    eng.bmm(x, w)
    assert backends.dispatch_counts() == {("eager", "matmul"): 1,
                                          ("eager", "bmm"): 2}
    log = backends.dispatch_log()
    assert [r["op"] for r in log] == ["matmul", "bmm", "bmm"]
    assert log[1]["shapes"] == (8, 8, 8) and log[1]["tiles"] == ()
    assert backends.get_backend("cuda").tiles(
        "bmm", (256, 5120, 8192), torch.float32) == ops.default_tiles(
            256, 5120, 8192)
    backends.reset_dispatch_counts()


def test_bmm_grad_skips_what_no_input_needs():
    """`BmmFn` computes dX only for an x that requires grad, as
    `GemmFused` does."""
    x = torch.randn(2, 5, 4)
    w = torch.randn(2, 4, 3, requires_grad=True)
    (dw,) = torch.autograd.grad((ops.bmm(x, w) ** 2).sum(), (w,))
    want = gemm.bmm_bwd_dw_plain(x, 2 * gemm.bmm_fwd_plain(x, w))
    assert torch.allclose(dw, want, rtol=1e-6, atol=1e-6)
