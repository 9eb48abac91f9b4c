"""`ops.attention_partial` (one key span's (o, lse) at a RELATIVE live
extent, the sequence split's building block) against the JAX package, on
the CPU.

The same numpy-seeded operands go through the port's `attention_partial`
(the lse forward's plain version, `relative=True`) and JAX's, whose Pallas
kernel runs in interpret mode, within 1e-5: relative extents above Skv,
inside it, 0 and negative, Sq 1, 4 and 8 (`DECODE_MAX_SQ` is 8; at Sq > 1
a clamped extent would cut the causal diagonal of a span that is not the
last), causal on and off, G 1 and 2, head dims 32 and 64.  The rows with no
live key carry the -1e30 sentinel exactly where JAX puts it.  The spans'
partials merged by `flash_decode.combine` give the port's unsharded
attention within 1e-5, and the clamped callers of `ref.attention_mask` keep
their bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import ref

torch.set_num_threads(1)

TOL = 1e-5
SKV = 64


def _qkv(rng, b, sq, skv, h, kv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32))


# (G, D): the group size and head dim, crossed with Sq and causal.
@pytest.mark.parametrize("g,d", [(1, 32), (2, 64)])
@pytest.mark.parametrize("sq", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_partial_matches_the_jax_pallas_kernel(g, d, sq, causal):
    rng = np.random.default_rng(100 * g + 10 * sq + causal)
    # above Skv, inside it (also past the causal edge), 0 and negative
    kv_len = np.array([SKV + 37, SKV // 2, 3, 0, -5], np.int32)
    q, k, v = _qkv(rng, len(kv_len), sq, SKV, 2 * g, 2, d)
    jo, jl = jax_ops.attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        None, causal=causal, interpret=True)
    o, lse = ops.attention_partial(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(kv_len), causal=causal)
    jo, jl = np.asarray(jo), np.asarray(jl)
    assert o.shape == jo.shape and lse.shape == jl.shape
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    dead = jl == fd.EMPTY_SPAN_LSE
    assert np.array_equal(lse.numpy() == fd.EMPTY_SPAN_LSE, dead)
    assert np.array_equal(lse.numpy()[dead], jl[dead])        # exact
    assert dead[3].all() and dead[4].all()                     # kv_len <= 0
    assert not dead[0].any()
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy()[~dead], jl[~dead], rtol=TOL,
                               atol=TOL)
    assert not o.numpy()[dead].any()                           # exact 0


@pytest.mark.parametrize("sq", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len", [None, [3, 300], [128, 257]])
def test_spans_merged_by_combine_give_the_unsharded_attention(sq, causal,
                                                              kv_len):
    rng = np.random.default_rng(7 * sq + causal)
    skv, n = 512, 4
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, 2, sq, skv, 4, 2, 32))
    kvl = (torch.full((2,), skv, dtype=torch.int32) if kv_len is None
           else torch.tensor(kv_len, dtype=torch.int32))
    span = skv // n
    parts = [ops.attention_partial(q, k[:, s * span:(s + 1) * span],
                                   v[:, s * span:(s + 1) * span],
                                   kvl - s * span, causal=causal)
             for s in range(n)]
    merged = fd.combine(torch.stack([o for o, _ in parts], 2),
                        torch.stack([lse for _, lse in parts], 2))
    want = ops.attention(q, k, v, kv_len, causal=causal)
    torch.testing.assert_close(merged.transpose(1, 2), want, rtol=0,
                               atol=TOL)


def test_a_clamped_span_would_cut_the_causal_diagonal():
    # kv_len 300 against a first span of 256 keys at Sq 4: the relative
    # extent right-aligns row i at 300 - 4 + i, so every key of the span
    # is live; clamped to 256 the rows 0-2 would lose keys 253-255.
    b, sq, skv = 1, 4, 256
    mask = ref.attention_mask(b, sq, skv, causal=True,
                              kv_len=torch.tensor([300]), device="cpu",
                              relative=True)
    clamped = ref.attention_mask(b, sq, skv, causal=True,
                                 kv_len=torch.tensor([300]), device="cpu")
    assert mask.all()
    assert not clamped[0, :3, 253:].all()


def _old_attention_mask(b, sq, skv, *, causal, kv_len):
    # the mask as it was before relative extents: clamp, then right-align
    kj, qi = torch.arange(skv), torch.arange(sq)
    if kv_len is None:
        mask = torch.ones((1, sq, skv), dtype=torch.bool)
        if causal:
            mask = mask & (kj[None, :] <= qi[:, None] + (skv - sq))[None]
        return mask
    kvl = torch.as_tensor(kv_len, dtype=torch.int64)
    kvl = torch.clamp(kvl.reshape(-1).expand(b), max=skv)
    mask = (kj[None, None] < kvl[:, None, None]).expand(b, sq, skv)
    if causal:
        mask = mask & (kj[None, None]
                       <= qi[None, :, None] + (kvl[:, None, None] - sq))
    return mask


@pytest.mark.parametrize("kv_len", [None, 40, [64, 0], [200, 5], [3, 64]])
@pytest.mark.parametrize("causal", [True, False])
def test_clamped_callers_of_the_mask_keep_their_bits(kv_len, causal):
    b, sq, skv = 2, 4, 64
    got = ref.attention_mask(b, sq, skv, causal=causal, kv_len=kv_len,
                             device="cpu")
    assert torch.equal(got, _old_attention_mask(b, sq, skv, causal=causal,
                                                kv_len=kv_len))
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, b, sq, skv, 4, 2, 32))
    kvl = (None if kv_len is None else torch.as_tensor(
        kv_len, dtype=torch.int32).reshape(-1).expand(b).contiguous())
    clamped = ops.normalize_kv_len(kvl, b, skv, "cpu")
    plain = fa.flash_attention_plain(q, k, v, clamped, causal=causal,
                                     return_lse=True)
    # within Skv the relative mode is the clamped one, bit for bit
    rel = fa.flash_attention_plain(q, k, v, clamped, causal=causal,
                                   return_lse=True, relative=True)
    assert all(torch.equal(a, r) for a, r in zip(plain, rel))
    assert torch.equal(fa.flash_attention_fwd(q, k, v, clamped,
                                              causal=causal), plain[0])


def test_partial_is_inference_only_and_needs_kv_len():
    q = torch.zeros(1, 1, 2, 32, requires_grad=True)
    k = torch.zeros(1, 64, 2, 32)
    with pytest.raises(NotImplementedError, match="inference only"):
        ops.attention_partial(q, k, k, 10)
    with pytest.raises(ValueError, match="relative kv_len"):
        ops.attention_partial(q.detach(), k, k, None)
