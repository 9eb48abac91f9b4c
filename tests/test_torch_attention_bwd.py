"""The port's attention backward against the JAX package, on the CPU.

The same numpy inputs go through ``jax.grad`` of the JAX Pallas attention
(``repro.kernels.ops.attention`` over ``flash_attention``'s custom VJP, in
interpret mode, as the JAX tests run it) and through the port: the
`FlashAttention` autograd Function and the backward kernels' plain
versions (which the wrappers run for a CPU tensor), the forward's lse
against ``flash_attention_with_lse``, and the engine's `attention` op
differentiated on `eager` against the JAX `xla` engine.  Cases: head groups
G = 1, 2, 7, causal and not, per-batch kv_len with a fully-masked row,
ragged Sq / Skv, head dims 32 / 64 / 128, hubert-xlarge's 80,
zamba2-7b's 112 and MLA's prefill 192 (under its one dQ plan, 16 rows);
the latent's 576 refused by name.  Bars: fp32 1e-5 max-relative
(the bar of ``tests/test_grad_conformance.py``), bf16 5e-2.  The kernels
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jax_make_engine
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_with_lse
from repro_torch.core import backends, make_engine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(1)

TOLS = {"float32": 1e-5, "bfloat16": 5e-2}
EAGER = make_engine("eager", device="cpu")
JAX_ENGINE = jax_make_engine("xla", "fp32_strict")

# b, sq, skv, h, kv, d, causal, kv_len
CASES = [
    (2, 16, 16, 2, 2, 32, True, None),             # G 1
    (1, 24, 40, 4, 2, 32, True, None),             # G 2, ragged, right-aligned
    (2, 20, 20, 7, 1, 64, False, [13, 0]),         # G 7, a fully-masked row
    (2, 33, 50, 14, 2, 64, True, [50, 20]),        # G 7, rows before kv_len
    (1, 8, 8, 3, 1, 128, False, None),             # G 3, head dim 128
    (2, 20, 20, 4, 4, 80, False, [13, 0]),         # hubert's head dim 80
    (1, 24, 40, 4, 2, 112, True, [40]),            # zamba2's 112, G 2
    (2, 16, 48, 4, 4, 192, True, [48, 20]),        # MLA's 192, G 1
    (1, 24, 40, 4, 2, 192, False, [17]),           # 192, G 2, not causal
]


def _relmax(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _inputs(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d))]


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _jax_grads(q, k, v, w, kv_len, causal, dtype):
    """(o, dq, dk, dv) of sum(attention(q, k, v) * w) through the Pallas
    kernels' custom VJP in interpret mode."""
    jdt = jnp.dtype(dtype)
    kvl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def loss(q, k, v):
        o = jax_ops.attention(q, k, v, kvl, causal=causal, bq=64, bk=64,
                              bq_bwd=64, bk_bwd=64, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *grads)]


def _port_grads(q, k, v, w, kv_len, causal, dtype):
    """(o, dq, dk, dv) through `ops.attention` -> `FlashAttention` on CPU
    tensors (the plain versions of the lse forward and the dQ / dK / dV
    kernels)."""
    qt, kt, vt = (_torch(x, dtype).requires_grad_() for x in (q, k, v))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    o = ops.attention(qt, kt, vt, kvl, causal=causal)
    grads = torch.autograd.grad((o.float() * _torch(w, torch.float32)).sum(),
                                (qt, kt, vt))
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,kv_len", CASES)
def test_flash_attention_function_matches_jax_grad(b, sq, skv, h, kv, d,
                                                   causal, kv_len, dtype):
    q, k, v, w = _inputs(sq * 100 + skv + h, b, sq, skv, h, kv, d)
    want = _jax_grads(q, k, v, w, kv_len, causal, dtype)
    got = _port_grads(q, k, v, w, kv_len, causal, getattr(torch, dtype))
    for name, g, x in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == x.shape, name          # dK / dV compact (B,Skv,KV,D)
        assert np.isfinite(g).all(), name
        err = _relmax(g, x)
        assert err <= TOLS[dtype], f"{name}: {err:.3e}"


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,kv_len", CASES)
def test_plain_backward_matches_autograd_of_the_oracle(b, sq, skv, h, kv, d,
                                                       causal, kv_len):
    """The backward wrappers on CPU tensors (the kernels' plain versions:
    P from lse, Delta from O) equal autograd through the forward oracle,
    fp32."""
    q, k, v, w = (_torch(x, torch.float32)
                  for x in _inputs(7 + d, b, sq, skv, h, kv, d))
    q = q / d ** 0.5                              # already scaled, as on the path
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    o, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                    return_lse=True)
    delta = (w * o).sum(-1).transpose(1, 2).contiguous()
    got = [fa.flash_attention_bwd_dq(q, k, v, w, lse, delta, kvl,
                                     causal=causal),
           *fa.flash_attention_bwd_dkv(q, k, v, w, lse, delta, kvl,
                                       causal=causal)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_plain(*leaves, kvl, causal=causal)
    want = torch.autograd.grad((ref * w).sum(), leaves)
    for g, x in zip(got, want):
        assert _relmax(g, x) <= TOLS["float32"]


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_flash_attention_with_lse(causal):
    b, s, h, kv, d = 2, 64, 6, 2, 32
    q, k, v, _ = _inputs(3, b, s, s, h, kv, d)
    q = q / d ** 0.5
    kv_len = np.array([0, 37], np.int32)
    jo, jlse = flash_attention_with_lse(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=causal, sm_scale=1.0, bq=32, bk=32,
        kv_len=jnp.asarray(kv_len).reshape(b, 1), interpret=True)
    o, lse = fa.flash_attention_fwd(*(_torch(x, torch.float32)
                                      for x in (q, k, v)),
                                    torch.from_numpy(kv_len), causal=causal,
                                    return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert _relmax(lse, jlse) <= TOLS["float32"]
    assert _relmax(o, np.asarray(jo).transpose(0, 2, 1, 3)) <= TOLS["float32"]
    assert bool((lse[0] == 0).all())              # the kv_len 0 row


def test_fully_masked_rows_give_exact_zero_gradients():
    b, s, h, kv, d = 2, 24, 4, 2, 32
    q, k, v = (_torch(x, torch.float32).requires_grad_()
               for x in _inputs(5, b, s, s, h, kv, d)[:3])
    kvl = torch.tensor([0, 9], dtype=torch.int32)
    o = fa.FlashAttention.apply(q, k, v, kvl, False)
    dq, dk, dv = torch.autograd.grad(o.square().sum() + o.sum(), (q, k, v))
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
        assert bool((g[0] == 0).all())            # the kv_len 0 row
    assert bool((dk[1, 9:] == 0).all() and (dv[1, 9:] == 0).all())
    assert bool((dk[1, :9] != 0).any())


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, [5, 12])])
def test_engine_attention_gradients_match_the_jax_xla_engine(causal, kv_len):
    b, sq, skv, h, kv, d = 2, 12, 16, 6, 2, 32
    q, k, v, w = _inputs(11, b, sq, skv, h, kv, d)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)

    def jloss(q, k, v):
        o = JAX_ENGINE.attention(q, k, v, causal=causal, kv_len=kvl)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [_torch(x, torch.float32).requires_grad_() for x in (q, k, v)]
    o = EAGER.attention(*leaves, causal=causal,
                        kv_len=None if kvl is None else torch.from_numpy(kvl))
    got = torch.autograd.grad((o * _torch(w, torch.float32)).sum(), leaves)
    for g, x in zip(got, want):
        assert _relmax(g, x) <= TOLS["float32"]


def test_guard_grad_refuses_a_decode_shaped_dispatch_on_cuda():
    """The split-KV decode formulation has no backward: the cuda backend
    declares those dispatches inference only, and `attention_decode`
    itself raises under grad; a training-shaped dispatch passes the guard
    and runs forward-only without grad."""
    cuda = backends.get_backend("cuda")
    qd = torch.zeros(1, 1, 4, 32, requires_grad=True)
    kd = torch.zeros(1, 256, 2, 32)
    with pytest.raises(NotImplementedError, match="inference only"):
        backends.guard_grad(cuda, "attention", qd, kd, kd)
    with pytest.raises(NotImplementedError, match="inference only"):
        ops.attention_decode(qd, kd, kd)
    backends.guard_grad(cuda, "attention", torch.zeros(
        1, 16, 4, 32, requires_grad=True), kd, kd)
    with torch.no_grad():
        backends.guard_grad(cuda, "attention", qd, kd, kd)
        assert ops.attention_decode(qd, kd, kd).shape == qd.shape


def test_backward_wrappers_check_their_operands():
    q, k, v, w = (_torch(x, torch.float32)
                  for x in _inputs(1, 1, 4, 4, 2, 1, 32))
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_bwd_dq(q, k, v, w[:, :2], lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dkv(q, k, v, w, lse[:, :1], lse)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd_dq(q, k, v, w, lse, lse.double())


@pytest.mark.parametrize("kernel", ["dq", "dkv", "autograd"])
def test_backward_refuses_head_dim_192_by_name(kernel):
    """The refusals that remain now that the backward takes MLA's 192 (the
    test keeps the name it had when 192 was refused whole): at 192 the dQ
    kernel refuses the 64-row plan, whose fp32 block does not fit in an
    SM's shared memory; and every entry point refuses a head dim it has
    no kernel for, the latent's 576 (never trained), by name, on a CPU
    tensor as on the card, before any work."""
    q = torch.zeros(1, 4, 2, 576)
    lse = torch.zeros(1, 2, 4)
    calls = {
        "dq": lambda: fa.flash_attention_bwd_dq(q, q, q, q, lse, lse),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, q, q, q, lse, lse),
        "autograd": lambda: fa.FlashAttention.apply(
            q.clone().requires_grad_(), q, q, None, True)}
    with pytest.raises(ValueError, match="head dim 576"):
        calls[kernel]()
    if kernel == "dq":
        q192 = torch.zeros(1, 4, 2, 192)
        with pytest.raises(ValueError, match="head dim 192"):
            fa.flash_attention_bwd_dq(q192, q192, q192, q192, lse, lse,
                                      plan=fa.BWD_PLANS[0])
        got = fa.flash_attention_bwd_dq(q192, q192, q192, q192, lse, lse,
                                        plan=fa.BWD_PLANS[1])
        assert got.shape == q192.shape
