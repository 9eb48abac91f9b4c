"""The port's attention against the JAX package, on the CPU.

The same numpy inputs go through the JAX oracle ``flash_attention_ref``,
the JAX Pallas wrappers ``ops.attention`` / ``ops.attention_decode`` (in
interpret mode, as the JAX tests run them) and the port's counterparts:
the kernels' plain versions (which the wrappers run for a CPU tensor), the
`ref`, `eager` and `cuda`-routing engine ops, and the split-KV partials and
their `combine`.  fp32 bar: 1e-5 max-relative (the bar of
``tests/test_grad_conformance.py``).  The kernels themselves run on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jax_decode
from repro.kernels import ops as jax_ops
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.core import make_engine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

torch.set_num_threads(1)

HEAD_RATIOS = [(16, 16), (14, 2), (8, 1)]
SHAPES = [(sq, skv) for sq in (1, 4, 16) for skv in (64, 256)]
TOL = 1e-5
EAGER = make_engine("eager", device="cpu")


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _inputs(seed, b, sq, skv, h, kv, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    return q, k, v


def _kv_lens(skv):
    """None, a scalar and a (B,) vector with a 0 row."""
    return [None, skv - 7, np.array([skv // 2 + 3, 0], np.int32)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", SHAPES)
@pytest.mark.parametrize("h,kv", HEAD_RATIOS)
def test_plain_versions_and_engine_ops_match_jax_oracle(h, kv, sq, skv,
                                                        causal):
    q, k, v = _inputs(h * 100 + sq * 10 + skv, 2, sq, skv, h, kv)
    for kvl in _kv_lens(skv):
        want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  kv_len=None if kvl is None
                                  else jnp.asarray(kvl)))
        tkvl = None if kvl is None else _t(kvl)
        got = {
            "forward": ops.attention(_t(q), _t(k), _t(v), tkvl,
                                     causal=causal),
            "decode": ops.attention_decode(_t(q), _t(k), _t(v), tkvl,
                                           causal=causal),
            "eager": EAGER.attention(_t(q), _t(k), _t(v), causal=causal,
                                     kv_len=tkvl),
            "ref": make_engine("ref", device="cpu").attention(
                _t(q), _t(k), _t(v), causal=causal, kv_len=tkvl)}
        for name, out in got.items():
            assert out.shape == (2, sq, h, 32) and out.dtype == torch.float32
            err = _relmax(out.numpy(), want)
            assert err <= TOL, (name, kvl, err)
        if kvl is not None and np.ndim(kvl) == 1:
            for out in got.values():            # the kv_len == 0 row
                assert torch.all(out[1] == 0), "row with no key must be 0"


@pytest.mark.parametrize("h,kv", HEAD_RATIOS)
def test_forward_matches_jax_pallas_kernel_interpret(h, kv):
    """The forward path against the JAX flash kernel in interpret mode, a
    prefill chunk right-aligned against a per-batch extent."""
    q, k, v = _inputs(h + kv, 2, 16, 256, h, kv)
    kvl = np.array([200, 37], np.int32)
    want = jax_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(kvl), causal=True, interpret=True)
    got = ops.attention(_t(q), _t(k), _t(v), _t(kvl), causal=True)
    assert _relmax(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("sq", [1, 4])
def test_decode_matches_jax_pallas_decode_interpret(sq):
    """Split-KV decode against the JAX decode kernel in interpret mode."""
    q, k, v = _inputs(sq, 2, sq, 384, 14, 2)
    kvl = np.array([384, 130], np.int32)
    want = jax_ops.attention_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(kvl),
                                    causal=sq > 1, bk_split=128, n_splits=3,
                                    interpret=True)
    got = ops.attention_decode(_t(q), _t(k), _t(v), _t(kvl), causal=sq > 1)
    assert _relmax(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("causal", [True, False])
def test_decode_partials_and_combine_match_jax_combine(causal):
    """The plain partials merge to the JAX oracle through both combines;
    spans past kv_len carry the -1e30 sentinel and zero partials, and
    rows with no live key come out exactly 0."""
    q, k, v = _inputs(7, 3, 4, 300, 8, 2)
    kvl = np.array([300, 70, 0], np.int32)
    qs = ops.scale_queries(_t(q))
    n_splits, span = ops.decode_splits(300, 2)
    o_part, lse_part = fd.flash_decode_partials(
        qs, _t(k), _t(v), _t(kvl), causal=causal, n_splits=n_splits,
        span=span)
    assert o_part.shape == (3, 8, n_splits, 4, 32)
    assert lse_part.shape == (3, 8, n_splits, 4)
    assert o_part.dtype == lse_part.dtype == torch.float32
    empty = lse_part == fd.EMPTY_SPAN_LSE
    assert torch.all(empty[2]) and torch.all(o_part[empty] == 0)
    assert torch.all(empty[1, :, 70 // span + 1:])     # spans past kv_len
    mine = fd.combine(o_part, lse_part)
    theirs = np.asarray(jax_decode.combine(jnp.asarray(o_part.numpy()),
                                           jnp.asarray(lse_part.numpy())))
    assert _relmax(mine.numpy(), theirs) <= TOL
    assert torch.all(mine[2] == 0) and np.all(theirs[2] == 0)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, kv_len=jnp.asarray(kvl)))
    assert _relmax(mine.transpose(1, 2).numpy(), want) <= TOL


def test_all_empty_decode_rows_are_exact_zero_not_nan():
    q, k, v = _inputs(9, 2, 4, 512, 8, 2)
    out = ops.attention_decode(_t(q), _t(k), _t(v), torch.zeros(2),
                               causal=True)
    assert not torch.isnan(out).any() and torch.all(out == 0)


def test_decode_formulation_boundary_is_the_jax_one():
    assert (ops.DECODE_MAX_SQ, ops.DECODE_MIN_SKV) == (
        jax_ops.DECODE_MAX_SQ, jax_ops.DECODE_MIN_SKV)
    for sq in (1, 8, 9):
        for skv in (255, 256, 1024):
            assert (ops.use_decode_formulation(sq, skv)
                    == jax_ops.use_decode_formulation(sq, skv))


@pytest.mark.parametrize("skv", [1, 64, 65, 256, 700, 1024, 4096])
@pytest.mark.parametrize("kv_heads", [1, 2, 10, 16])
def test_decode_splits_cover_the_extent_from_the_shape_alone(skv, kv_heads):
    n_splits, span = ops.decode_splits(skv, kv_heads)
    assert span % fd.TILE == 0 and span >= fd.TILE
    assert n_splits * span >= skv > (n_splits - 1) * span  # no empty span
    assert n_splits * kv_heads <= max(132 + kv_heads, kv_heads)


def test_single_split_plain_decode_equals_plain_forward():
    """At one split the partial is the forward's output: the plain versions
    agree to rounding here; on the card the kernels agree bit for bit
    (tests/test_torch_cuda.py)."""
    q, k, v = _inputs(11, 2, 8, 256, 14, 2)
    kvl = torch.tensor([256, 100], dtype=torch.int32)
    o_part, lse_part = fd.flash_decode_plain(_t(q), _t(k), _t(v), kvl,
                                             causal=True, n_splits=1,
                                             span=256)
    fwd = fa.flash_attention_plain(_t(q), _t(k), _t(v), kvl, causal=True)
    assert _relmax(o_part[:, :, 0].transpose(1, 2).numpy(),
                   fwd.numpy()) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v = (torch.zeros(2, 4, 8, 32), torch.zeros(2, 64, 2, 32),
               torch.zeros(2, 64, 2, 32))
    with pytest.raises(ValueError, match="head grouping"):
        fa.flash_attention_fwd(q, torch.zeros(2, 64, 3, 32),
                               torch.zeros(2, 64, 3, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_fwd(q, k, v, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="needs kv_len"):
        fd.flash_decode_partials(q, k, v, None, causal=True, n_splits=1,
                                 span=64)
    kvl = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not cover"):
        fd.flash_decode_partials(q, torch.zeros(2, 200, 2, 32),
                                 torch.zeros(2, 200, 2, 32), kvl,
                                 causal=True, n_splits=3, span=64)
    with pytest.raises(ValueError, match="multiple"):
        fd.flash_decode_partials(q, k, v, kvl, causal=True, n_splits=1,
                                 span=96)


def test_engine_attention_contract_errors():
    q = torch.zeros(2, 8, 4, 32)
    k = v = torch.zeros(2, 4, 2, 32)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        EAGER.attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="evenly divide"):
        EAGER.attention(q[:, :2], torch.zeros(2, 4, 3, 32),
                        torch.zeros(2, 4, 3, 32))
    with pytest.raises(ValueError, match="kv_len"):
        EAGER.attention(q[:, :2], k, v, kv_len=torch.zeros(3))


def test_cuda_attention_is_forward_only_and_refuses_cpu_tensors():
    """`attention` is in the cuda backend's differentiable set, but its
    decode-shaped dispatches (the split-KV kernel) are forward only: one
    differentiated raises NotImplementedError naming the op.  On a CPU
    tensor the cuda backend raises instead of falling back, with or
    without grad."""
    from repro_torch.core import ComputeEngine, get_backend
    assert "attention" in get_backend("cuda").differentiable
    eng = ComputeEngine(backend="cuda", device=torch.device("cpu"))
    qd = torch.zeros(1, 1, 4, 32, requires_grad=True)
    kd = vd = torch.zeros(1, 256, 2, 32)
    with pytest.raises(NotImplementedError, match="'attention'"):
        eng.attention(qd, kd, vd, causal=False)
    q = torch.zeros(1, 2, 4, 32, requires_grad=True)
    k = v = torch.zeros(1, 2, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.attention(q.detach(), k, v)
