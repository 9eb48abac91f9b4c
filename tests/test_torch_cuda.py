"""The port's CUDA kernel on the card (marker `cuda`).

These tests need an NVIDIA GPU and the CUDA toolkit; without a card each
skips with the reason.  This file imports neither jax nor the JAX package,
so it runs on a machine that has PyTorch for CUDA and no jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax.)  It holds the
fused-GEMM kernel, its residual variant and the dX / dW kernels against
their plain versions, checks the row-independence that bucketed serving
relies on, that a training forward leaves the serving bits unchanged and
that a split dW gives the same bits twice, and runs a small network and a
small train step on the `cuda` engine against `eager` on the same card.
For the LM: the GEMM reading a transposed weight in place (the tied head),
the flash-attention and split-KV decode kernels against their plain
versions (and bit for bit against each other at one split, and across
batch sizes and block heights; the decode launch's merge bit for bit
`combine`), the reduced qwen2-0.5b on `cuda` against `eager`, and
the paged engine on `cuda` launching both kernels.  For LM training: the
tied head's `GemmFused` gradients through ``embed.t()`` against a
row-major copy, the lse forward and the dQ / dK / dV kernels against
their plain versions (exact-0 dead rows, two runs bitwise), and the
reduced qwen2-0.5b's loss gradients and a train step on `cuda` against
`eager`.  For the SSM: the SSD chunk-scan kernel against its plain version
(ragged S, groups, an initial state, fp32 and bf16, two runs bitwise),
every SSD plan bit for bit the path plan's, the
reduced mamba2-1.3b's prefill and decode on `cuda` against `eager`, and
the slot engine on `cuda` prefilling through the kernel.  For the engine
`bmm` op: the batched forward, dX and dW kernels against their plain
versions, every batch slice bit for bit the 2-D kernel's at the same plan,
and `make_engine("cuda").bmm` with its gradient against `eager`.  For the
direct convolution: the kernel against its plain version under every
plan (ragged bands, 1x1, asymmetric, th > OH, fp32 and bf16, two runs
bitwise), and every plan bit for bit the path plan's on a ragged grid; for
the flash forward, every plan, with and without lse, bit for bit the path
plan's.
"""
import pytest
import torch

import numpy as np

from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG, SEGNET_SMALL_CFG
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm, ops
from repro_torch.kernels import conv_direct, ssd
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.kernels.common import ACTIVATIONS, epilogue
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_cnn_train_step, make_train_step
from repro_torch.tree import flatten

pytestmark = pytest.mark.cuda

MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99),
                (1, 27, 1000), (300, 1, 7)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode; "
                    "the CPU path is tested in test_torch_kernels_gemm.py")
    return torch.device("cuda", 0)


def _relmax(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_kernel_matches_plain_version(card, m, k, n, dtype, tol):
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=card).to(dtype)
    w = (torch.randn(k, n, generator=g, device=card) / k ** 0.5).to(dtype)
    scale = torch.rand(n, generator=g, device=card) + 0.5
    shift = torch.randn(n, generator=g, device=card) * 0.1
    for act in ACTIVATIONS:
        for sc, sh in ((None, None), (scale, shift)):
            want = gemm.gemm_fused_plain(x, w, sc, sh, act=act)
            for plan in gemm.PLANS:
                before = gemm.launch_counts()
                got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act, plan=plan)
                after = gemm.launch_counts()
                assert after["gemm_fused_fwd"] == before["gemm_fused_fwd"] + 1
                regime = f"gemm_fwd_regime_{plan.regime.lower()}"
                assert after[regime] == before[regime] + 1
                assert got.dtype == dtype and tuple(got.shape) == (m, n)
                assert _relmax(got, want) <= tol, (act, plan)


@pytest.mark.parametrize("m,k,n,trans", [(70, 300, 90, False),
                                         (71, 4864, 896, False),
                                         (72, 896, 3000, True)])
def test_rows_do_not_depend_on_m_or_tile(card, m, k, n, trans):
    """A row's result is bitwise the same alone, inside a larger M, and
    under every plan of either regime: no split-K, one fixed summation
    order.  At LM widths (qwen2-0.5b's down projection, and a tied head
    read transposed) rows 0:1, 0:8 and 0:64 go through regime A and the
    full product through regime B."""
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=card)
    w = torch.randn(n, k, generator=g, device=card).t() if trans else \
        torch.randn(k, n, generator=g, device=card)
    shift = torch.randn(n, generator=g, device=card)
    full = {p: gemm.gemm_fused_fwd(x, w, None, shift, act="leaky", plan=p)
            for p in gemm.PLANS}
    assert gemm.plan_for(m, k, n).regime == "B"
    want = full[gemm.plan_for(m, k, n)]
    assert all(torch.equal(y, want) for y in full.values())
    for rows in (slice(0, 1), slice(0, 8), slice(0, 64), slice(5, 8),
                 slice(64, m)):
        part = gemm.gemm_fused_fwd(x[rows].contiguous(), w, None, shift,
                                   act="leaky")
        assert gemm.plan_for(rows.stop - rows.start, k, n).regime == "A"
        assert torch.equal(part, want[rows])


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros(4, 8, device=card)
    w = torch.zeros(8, 3, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.gemm_fused_fwd(torch.zeros(8, 4, device=card).t(), w)
    with pytest.raises(ValueError, match="plan"):
        gemm.gemm_fused_fwd(x, w, plan=("A", 32, 32))
    with pytest.raises(ValueError, match="on cpu"):
        gemm.gemm_fused_fwd(x, w.cpu())
    assert tuple(ops.matmul(x, w).shape) == (4, 3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,k,n", MATMUL_CASES + [(64, 896, 3000)])
def test_transposed_weight_gives_the_row_major_bits(card, m, k, n, dtype,
                                                    tol):
    """w read transposed in place (a tied LM head's embed.t()) gives the
    bits of its row-major copy, within the bar of the plain version; so
    does the residual forward (the training launch), y and g alike."""
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=card).to(dtype)
    table = (torch.randn(n, k, generator=g, device=card) / k ** 0.5).to(dtype)
    w = table.t()
    shift = torch.randn(n, generator=g, device=card)
    assert gemm.is_transposed(w) or min(k, n) == 1
    for act in ACTIVATIONS:
        want = gemm.gemm_fused_plain(x, w, None, shift, act=act)
        for plan in gemm.PLANS:
            got = gemm.gemm_fused_fwd(x, w, None, shift, act=act, plan=plan)
            assert torch.equal(got, gemm.gemm_fused_fwd(
                x, w.contiguous(), None, shift, act=act, plan=plan))
            assert _relmax(got, want) <= tol
    if gemm.is_transposed(w):
        for act, plan in zip(("linear", "silu") * 3, gemm.PLANS):
            got = gemm.gemm_fused_fwd(x, w, None, shift, act=act,
                                      residuals=True, plan=plan)
            want = gemm.gemm_fused_fwd(x, w.contiguous(), None, shift,
                                       act=act, residuals=True, plan=plan)
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(got, want))


@pytest.mark.parametrize("cfg", [DARKNET_SMALL_CFG, SEGNET_SMALL_CFG])
def test_network_on_cuda_engine_matches_eager(card, cfg):
    net = Network(cfg, make_engine("cuda"),
                  generator=torch.Generator().manual_seed(0))
    ref = Network(cfg, make_engine("eager", device=card))
    ref.load_state_dict(net.state_dict())
    x = torch.randn((3, *net.in_shape), generator=torch.Generator()
                    .manual_seed(1)).to(card)
    with torch.inference_mode():
        got, want = net(x), ref(x)
    assert _relmax(got, want) <= 1e-4


def _operands(card, m, k, n, dtype=torch.float32, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + m + k + n)
    x = torch.randn(m, k, generator=g, device=card).to(dtype)
    w = (torch.randn(k, n, generator=g, device=card) / k ** 0.5).to(dtype)
    scale = torch.rand(n, generator=g, device=card) + 0.5
    shift = torch.randn(n, generator=g, device=card) * 0.1
    return x, w, scale, shift


@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_residual_kernel_matches_plain_and_keeps_the_serving_bits(card, m,
                                                                  k, n):
    x, w, scale, shift = _operands(card, m, k, n)
    u_all = torch.matmul(x, w)
    for act in ACTIVATIONS:
        for sc, sh in ((None, None), (scale, None), (scale, shift)):
            want = gemm.gemm_fused_res_plain(x, w, sc, sh, act=act)
            u = epilogue(u_all, sc, sh, "linear")
            for plan in gemm.PLANS:
                before = gemm.launch_counts()
                got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act, plan=plan,
                                          residuals=True)
                after = gemm.launch_counts()
                assert after["gemm_fused_fwd_res"] == before[
                    "gemm_fused_fwd_res"] + 1
                assert after["gemm_fused_fwd"] == before["gemm_fused_fwd"]
                assert torch.equal(got[0], gemm.gemm_fused_fwd(
                    x, w, sc, sh, act=act, plan=plan))
                assert (got[1] is None) == (act == "linear")
                assert (got[2] is None) == (sc is None)
                assert _relmax(got[0], want[0]) <= 1e-5
                if got[1] is not None:
                    # relu/leaky step at u = 0: compare away from the kink.
                    away = u.abs() > 1e-5 * u.abs().max()
                    assert _relmax(got[1][away], want[1][away]) <= 1e-5
                if got[2] is not None:
                    assert _relmax(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,k,n", MATMUL_CASES + [(4096, 27, 32)])
def test_bwd_kernels_match_plain_versions(card, m, k, n, dtype, tol):
    x, w, _, _ = _operands(card, m, k, n, dtype, seed=1)
    dy = torch.randn(m, n, device=card).to(dtype)
    want_dx = gemm.gemm_bwd_dx_plain(dy, w)
    want_dw = gemm.gemm_bwd_dw_plain(x, dy)
    for plan in gemm.BWD_PLANS:
        for splits in (1, 2, 7):
            before = gemm.launch_counts()
            dx = gemm.gemm_bwd_dx(dy, w, plan=plan, splits=splits)
            dw = gemm.gemm_bwd_dw(x, dy, plan=plan, splits=splits)
            after = gemm.launch_counts()
            assert after["gemm_bwd_dx"] == before["gemm_bwd_dx"] + 1
            assert after["gemm_bwd_dw"] == before["gemm_bwd_dw"] + 1
            reduces = (gemm.split_chunk(n, splits)[1] > 1) + (
                gemm.split_chunk(m, splits)[1] > 1)
            assert after["gemm_bwd_reduce"] == before[
                "gemm_bwd_reduce"] + reduces
            assert dx.dtype == dw.dtype == dtype
            assert tuple(dx.shape) == (m, k) and tuple(dw.shape) == (k, n)
            assert _relmax(dx, want_dx) <= tol, (plan, splits)
            assert _relmax(dw, want_dw) <= tol, (plan, splits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", MATMUL_CASES + [(4096, 27, 32),
                                                  (300, 896, 2000)])
def test_every_backward_plan_gives_the_same_bits(card, m, k, n, dtype):
    """The plan is for speed only: at the path's split every plan gives
    the path plan's bits, and dX in one piece is the forward kernel's
    dY @ W^T."""
    x, w, _, _ = _operands(card, m, k, n, dtype, seed=4)
    dy = torch.randn(m, n, device=card).to(dtype)
    for fn, args, case in (
            (gemm.gemm_bwd_dx, (dy, w), ("dx", m, n, k)),
            (gemm.gemm_bwd_dx, (dy, w.t().contiguous().t()), ("dx", m, n, k)),
            (gemm.gemm_bwd_dw, (x, dy), ("dw", k, m, n)),
            (gemm.gemm_bwd_dw, (dy, x), ("dw", n, m, k))):
        pick, splits = ops.bwd_plan(*case)
        want = fn(*args, plan=pick, splits=splits)
        for plan in gemm.BWD_PLANS:
            assert torch.equal(fn(*args, plan=plan, splits=splits), want)
    for plan in gemm.BWD_PLANS:
        assert torch.equal(gemm.gemm_bwd_dx(dy, w, plan=plan),
                           gemm.gemm_fused_fwd(dy, w.t()))


def test_split_dw_gives_the_same_bits_twice(card):
    x, _, _, _ = _operands(card, 100352, 288, 64, seed=2)
    dy = torch.randn(100352, 64, device=card)
    plan, splits = ops.bwd_plan("dw", 288, 100352, 64)
    assert splits > 1
    first = gemm.gemm_bwd_dw(x, dy, plan=plan, splits=splits)
    assert torch.equal(first, gemm.gemm_bwd_dw(x, dy, plan=plan,
                                               splits=splits))


def test_bwd_wrappers_refuse_what_the_kernels_do_not_take(card):
    dy = torch.zeros(8, 5, device=card)
    w = torch.zeros(4, 5, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.gemm_bwd_dx(dy, torch.zeros(4, 10, device=card)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        gemm.gemm_bwd_dw(torch.zeros(4, 8, device=card).t(), dy)
    with pytest.raises(ValueError, match="plan"):
        gemm.gemm_bwd_dx(dy, w, plan=(16, 16))
    with pytest.raises(ValueError, match="on cpu"):
        gemm.gemm_bwd_dw(torch.zeros(8, 4, device=card), dy.cpu())


def test_small_train_step_on_cuda_matches_eager(card):
    cuda = Network(DARKNET_SMALL_CFG, make_engine("cuda"),
                   generator=torch.Generator().manual_seed(0))
    eager = Network(DARKNET_SMALL_CFG, make_engine("eager", device=card))
    eager.load_state_dict(cuda.state_dict())
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    g = torch.Generator().manual_seed(1)
    batch = (torch.randn((4, *cuda.in_shape), generator=g).to(card),
             torch.randint(0, 10, (4,), generator=g).to(card))
    results = []
    for net in (cuda, eager):
        state = opt.adamw_init(dict(net.named_parameters()))
        gemm.reset_launches()
        state, metrics = make_cnn_train_step(net, ocfg)(state, batch)
        results.append((metrics, gemm.launch_counts(), state))
    (mc, lc, sc), (me, le, se) = results
    assert lc["gemm_fused_fwd_res"] == 4 and lc["gemm_bwd_dw"] == 4
    assert lc["gemm_bwd_dx"] == 3 and lc["gemm_fused_fwd"] == 0
    assert sum(le.values()) == 0  # eager launches none of the kernels
    assert abs(mc["loss"].item() - me["loss"].item()) <= 1e-5 * abs(
        me["loss"].item())
    for name, p in eager.named_parameters():
        assert _relmax(dict(cuda.named_parameters())[name], p) <= 1e-4
        assert _relmax(sc["mu"][name], se["mu"][name]) <= 1e-4


HEAD_RATIOS = [(16, 16), (14, 2), (8, 1)]


def _qkv(card, b, sq, skv, h, kv, d, dtype=torch.float32, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + sq + skv + h + d)
    q = (torch.randn(b, sq, h, d, generator=g, device=card) / d ** 0.5)
    k = torch.randn(b, skv, kv, d, generator=g, device=card)
    v = torch.randn(b, skv, kv, d, generator=g, device=card)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,kv", HEAD_RATIOS)
def test_attention_kernels_match_plain_versions(card, h, kv, d, dtype, tol):
    for sq, skv in ((1, 64), (4, 256), (16, 256), (64, 700)):
        q, k, v = _qkv(card, 2, sq, skv, h, kv, d, dtype)
        kvl = torch.tensor([skv, skv // 3], dtype=torch.int32, device=card)
        for causal in (True, False):
            for lens in (None, kvl):
                before = fa.launches
                got = fa.flash_attention_fwd(q, k, v, lens, causal=causal)
                assert fa.launches == before + 1
                want = fa.flash_attention_plain(q, k, v, lens, causal=causal)
                assert got.dtype == dtype
                assert _relmax(got, want) <= tol, (sq, skv, causal)
            n_splits, span = ops.decode_splits(skv, kv)
            before = fd.launches
            o, lse = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                              n_splits=n_splits, span=span)
            assert fd.launches == before + 1
            wo, wl = fd.flash_decode_plain(q, k, v, kvl, causal=causal,
                                           n_splits=n_splits, span=span)
            assert torch.equal(lse == fd.EMPTY_SPAN_LSE,
                               wl == fd.EMPTY_SPAN_LSE)
            assert _relmax(o, wo) <= tol and _relmax(lse, wl) <= tol


@pytest.mark.parametrize("h,kv", HEAD_RATIOS)
def test_single_split_decode_is_the_forward_kernel_bit_for_bit(card, h, kv):
    for sq, skv in ((1, 256), (8, 1024), (3, 700)):
        q, k, v = _qkv(card, 2, sq, skv, h, kv, 64, seed=1)
        kvl = torch.tensor([skv, 130], dtype=torch.int32, device=card)
        for causal in (True, False):
            o, _ = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                            n_splits=1,
                                            span=-(-skv // 64) * 64)
            fwd = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
            assert torch.equal(o[:, :, 0].transpose(1, 2), fwd)


@pytest.mark.parametrize("h,kv", [(16, 16), (14, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_merge_in_the_decode_launch_is_combines_bits(card, h, kv, dtype):
    for sq, skv in ((1, 1024), (4, 256), (8, 512), (1, 3000)):
        q, k, v = _qkv(card, 3, sq, skv, h, kv, 64, dtype, seed=sq + h)
        kvl = torch.tensor([skv, skv // 3, 0], dtype=torch.int32,
                           device=card)
        ns, span = ops.decode_splits(skv, kv)
        parts = fd.flash_decode_partials(q, k, v, kvl, causal=sq > 1,
                                         n_splits=ns, span=span)
        before = fd.launches
        runs = [fd.flash_decode(q, k, v, kvl, causal=sq > 1, n_splits=ns,
                                span=span) for _ in range(2)]
        torch.cuda.synchronize()
        assert fd.launches == before + 2
        for out, o_part, lse_part in runs:
            assert torch.equal(o_part, parts[0])
            assert torch.equal(lse_part, parts[1])
            assert torch.equal(out, fd.merge_plain(*parts, dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("sq,skv,kv", [(1, 3072, 1), (4, 3072, 1),
                                       (1, 4096, 1), (4, 4096, 1),
                                       (1, 4224, 2)])
def test_decode_past_the_merges_split_limit(card, sq, skv, kv, dtype, tol):
    """`ops.attention_decode` at MERGE_MAX_SPLITS splits merges in the
    kernel's launch, past them through `merge_plain`; both agree with the
    plain attention, and the launch refuses to merge past the limit."""
    h = 8 * kv
    q, k, v = _qkv(card, 2, sq, skv, h, kv, 64, dtype, seed=skv + sq)
    kvl = torch.tensor([skv, skv // 3], dtype=torch.int32, device=card)
    ns, span = ops.decode_splits(skv, kv)
    assert (ns == fd.MERGE_MAX_SPLITS) == (skv == 3072)
    before = fd.launches
    got = ops.attention_decode(q, k, v, kvl, causal=sq > 1)
    assert fd.launches == before + 1
    qs = ops.scale_queries(q)
    parts = fd.flash_decode_partials(qs, k, v, kvl, causal=sq > 1,
                                     n_splits=ns, span=span)
    assert torch.equal(got, fd.merge_plain(*parts, dtype))
    want = fa.flash_attention_plain(qs, k, v, kvl, causal=sq > 1)
    assert _relmax(got, want) <= tol
    if ns > fd.MERGE_MAX_SPLITS:
        with pytest.raises(ValueError, match="merges at most"):
            fd.flash_decode(qs, k, v, kvl, causal=sq > 1, n_splits=ns,
                            span=span)


def test_attention_rows_do_not_depend_on_the_batch(card):
    """A sequence's output is bitwise the same alone and inside a batch of
    8, through both formulations and the merge."""
    q, k, v = _qkv(card, 8, 1, 1024, 14, 2, 64, seed=2)
    kvl = torch.arange(300, 1100, 100, dtype=torch.int32, device=card)
    for fn in (ops.attention, ops.attention_decode):
        full = fn(q, k, v, kvl, causal=False)
        one = fn(q[:1], k[:1], v[:1], kvl[:1], causal=False)
        assert torch.equal(full[:1], one)


def test_block_rows_do_not_change_the_bits(card):
    """A launch whose 64-row grid fills the card takes 64-row blocks, a
    smaller one 16-row blocks; a sequence's output is the same bits in
    both (a batch of 12 against the sequence alone), in both kernels."""
    q, k, v = _qkv(card, 12, 64, 1024, 14, 2, 64, seed=4)
    kvl = torch.arange(200, 1100, 75, dtype=torch.int32, device=card)
    full = fa.flash_attention_fwd(q, k, v, kvl, causal=True)
    one = fa.flash_attention_fwd(q[:1], k[:1], v[:1], kvl[:1], causal=True)
    assert torch.equal(full[:1], one)
    q, k, v = _qkv(card, 8, 1, 1024, 14, 2, 64, seed=5)
    kvl = kvl[:8]
    ns, span = ops.decode_splits(1024, 2)
    full = fd.flash_decode_partials(q, k, v, kvl, causal=False,
                                    n_splits=ns, span=span)
    one = fd.flash_decode_partials(q[:1], k[:1], v[:1], kvl[:1],
                                   causal=False, n_splits=ns, span=span)
    assert torch.equal(full[0][:1], one[0]) and torch.equal(full[1][:1],
                                                            one[1])


def test_empty_rows_are_exact_zero_on_the_card(card):
    q, k, v = _qkv(card, 2, 4, 512, 8, 2, 64, seed=3)
    zero = torch.zeros(2, dtype=torch.int32, device=card)
    for out in (ops.attention(q, k, v, zero),
                ops.attention_decode(q, k, v, zero)):
        assert torch.all(out == 0)


def test_reduced_lm_on_cuda_matches_eager(card):
    cfg = reduced(get_arch("qwen2-0.5b"))
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=card).manual_seed(0), device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300),
                           generator=torch.Generator().manual_seed(1)).to(card)
    with torch.inference_mode():
        got = make_prefill_step(make_engine("cuda"), cfg)(params, tokens)
        want = make_prefill_step(make_engine("eager", device=card), cfg)(
            params, tokens)
    assert _relmax(got[0], want[0]) <= 1e-4
    assert _relmax(got[1][0]["k"], want[1][0]["k"]) <= 1e-4


def test_paged_engine_on_cuda_launches_both_attention_kernels(card):
    cfg = reduced(get_arch("qwen2-0.5b"))
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=card).manual_seed(0), device=card)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                    max_new=4) for i, n in enumerate((300, 40, 5))]
    fa.reset_launches()
    fd.reset_launches()
    paged = PagedServingEngine(cfg, params, kv_blocks=64, block_size=16,
                               max_len=512, chunk=64, prefill_budget=128)
    paged.run(reqs)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert fa.launches > 0 and fd.launches > 0
    st = paged.stats()
    assert st["compile"]["traces"] <= st["trace_bound"]


@pytest.mark.parametrize("m,k,n", [(64, 128, 512), (100, 64, 1000)])
def test_tied_head_gradients_on_the_card_equal_a_row_major_copy(card, m, k,
                                                                 n):
    """GemmFused reads w = E^T in place: forward, dX = dY E and
    dE = dY^T X give the bits of the same GEMMs on a row-major copy."""
    g = torch.Generator(device=card).manual_seed(m + n)
    table = torch.randn(n, k, generator=g, device=card) / k ** 0.5
    x = torch.randn(m, k, generator=g, device=card)
    dy = torch.randn(m, n, generator=g, device=card)
    e = table.clone().requires_grad_()
    w = table.t().contiguous().requires_grad_()
    xs = [x.clone().requires_grad_() for _ in range(2)]
    before = gemm.launch_counts()
    y_t = ops.matmul(xs[0], e.t())
    dx_t, de = torch.autograd.grad(y_t, (xs[0], e), dy)
    after = gemm.launch_counts()
    assert after["gemm_fused_fwd_res"] == before["gemm_fused_fwd_res"] + 1
    assert after["gemm_bwd_dx"] == before["gemm_bwd_dx"] + 1
    assert after["gemm_bwd_dw"] == before["gemm_bwd_dw"] + 1
    y_r = ops.matmul(xs[1], w)
    dx_r, dw = torch.autograd.grad(y_r, (xs[1], w), dy)
    assert torch.equal(y_t, y_r) and torch.equal(dx_t, dx_r)
    assert de.shape == table.shape
    assert _relmax(de, dw.t()) <= 1e-5
    assert _relmax(de, gemm.gemm_bwd_dw_plain(dy, x)) <= 1e-5


ATTN_BWD_CASES = [  # b, sq, skv, h, kv, d, causal, kv_len
    (2, 64, 64, 2, 2, 32, True, None),
    (1, 40, 100, 4, 2, 64, True, None),
    (2, 70, 70, 14, 2, 64, False, [50, 0]),
    (2, 33, 130, 14, 2, 64, True, [130, 20]),
    (1, 16, 16, 3, 1, 128, False, None),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,kv_len", ATTN_BWD_CASES)
def test_attention_bwd_kernels_match_plain_versions(card, b, sq, skv, h, kv,
                                                    d, causal, kv_len, dtype,
                                                    tol):
    q, k, v = _qkv(card, b, sq, skv, h, kv, d, dtype, seed=7)
    do = torch.randn(q.shape, device=card).to(dtype)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                   device=card)
    o, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                    return_lse=True)
    wo, wlse = fa.flash_attention_plain(q, k, v, kvl, causal=causal,
                                        return_lse=True)
    assert torch.equal(o, fa.flash_attention_fwd(q, k, v, kvl,
                                                 causal=causal))
    assert _relmax(o, wo) <= tol and _relmax(lse, wlse) <= tol
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, kvl,
                                   causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, kvl,
                                        causal=causal)
    want = (fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, kvl,
                                            causal=causal),
            *fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, kvl,
                                              causal=causal))
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape
        assert bool(torch.isfinite(got).all())
        assert _relmax(got, w) <= tol
    assert torch.equal(dq, fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, kvl, causal=causal))
    again = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, kvl,
                                       causal=causal)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    for plan in fa.BWD_PLANS:  # every plan gives the path plan's bits
        assert torch.equal(dq, fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, kvl, causal=causal, plan=plan))
    if kv_len is not None and kv_len[-1] < skv:   # dead keys, dead rows
        assert bool((dk[-1, kv_len[-1]:] == 0).all())
    if kv_len == [50, 0]:
        assert bool((dq[1] == 0).all() and (dk[1] == 0).all())


def test_reduced_lm_loss_gradients_on_cuda_match_eager(card):
    cfg = reduced(get_arch("qwen2-0.5b"))
    batch = {k: torch.from_numpy(v).to(card) for k, v in SyntheticLM(
        cfg, ShapeConfig("t", 128, 2, "train"), seed=0).batch(0).items()}
    out = {}
    for name in ("cuda", "eager"):
        params = tfm.init_params(cfg, generator=torch.Generator(
            device=card).manual_seed(0), device=card)
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_()
        fa.reset_launches()
        loss = tfm.loss_fn(make_engine(name, device=card), cfg, params,
                           batch, ce_chunk=64)
        out[name] = (loss, torch.autograd.grad(loss, leaves),
                     fa.launch_counts())
    assert abs(out["cuda"][0].item() - out["eager"][0].item()) <= \
        1e-5 * abs(out["eager"][0].item())
    for a, b in zip(out["cuda"][1], out["eager"][1]):
        assert _relmax(a, b) <= 1e-4
    n = cfg.n_layers
    assert out["cuda"][2] == {"flash_attention": 0,
                              "flash_attention_lse": 2 * n,
                              "flash_attention_bwd_dq": n,
                              "flash_attention_bwd_dkv": n}


def test_reduced_lm_train_step_is_deterministic_on_the_card(card):
    cfg = reduced(get_arch("qwen2-0.5b"))
    batch = {k: torch.from_numpy(v).to(card) for k, v in SyntheticLM(
        cfg, ShapeConfig("t", 128, 2, "train"), seed=1).batch(0).items()}
    runs = []
    for _ in range(2):
        params = tfm.init_params(cfg, generator=torch.Generator(
            device=card).manual_seed(0), device=card)
        step = make_train_step(make_engine("cuda"), cfg, opt.AdamWConfig(),
                               ce_chunk=64)
        params, _, m = step(params, opt.adamw_init(flatten(params)), batch)
        runs.append((m["loss"], flatten(params)))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


# (batch, S, H, P, G, N, chunk): a multiple of the chunk and ragged, G 1
# and 2, P 32 and 64, N 16 and 128, chunks shorter and longer than a tile
SSD_CASES = [(1, 256, 4, 64, 1, 128, 256), (2, 100, 4, 32, 2, 16, 64),
             (4, 130, 8, 64, 2, 128, 64), (1, 70, 4, 32, 1, 16, 32)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain_version(card, b, s, h, p, g, n, chunk,
                                          dtype, tol):
    gen = torch.Generator(device=card).manual_seed(s + n)
    x = torch.randn(b, s, h, p, generator=gen, device=card).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=card) - 0.5)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=card))
    bm = torch.randn(b, s, g, n, generator=gen, device=card).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen, device=card).to(dtype)
    init = torch.randn(b, h, p, n, generator=gen, device=card)
    da = (dt * a).contiguous()
    for state in (None, init):
        want = ssd.ssd_scan_plain(x, dt, da, bm, cm, chunk=chunk,
                                  init_state=state)
        before = ssd.launches
        got = ops.ssd(x, dt, a, bm, cm, chunk=chunk, init_state=state)
        again = ops.ssd(x, dt, a, bm, cm, chunk=chunk, init_state=state)
        torch.cuda.synchronize()
        assert ssd.launches == before + 2
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        assert _relmax(got[0], want[0]) <= tol
        assert _relmax(got[1], want[1]) <= tol
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES + [
    (1, 23, 64, 64, 1, 128, 256), (2, 300, 8, 64, 1, 128, 256)])
def test_every_ssd_plan_gives_the_path_plans_bits(card, b, s, h, p, g, n,
                                                  chunk, dtype):
    gen = torch.Generator(device=card).manual_seed(s + h)
    x = torch.randn(b, s, h, p, generator=gen, device=card).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=card) - 0.5)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=card))
    bm = torch.randn(b, s, g, n, generator=gen, device=card).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen, device=card).to(dtype)
    init = torch.randn(b, h, p, n, generator=gen, device=card)
    da = (dt * a).contiguous()
    for state in (None, init):
        want = ssd.ssd_scan(x, dt, da, bm, cm, chunk=chunk, init_state=state)
        for plan in ssd.PLANS:
            got = ssd.ssd_scan(x, dt, da, bm, cm, chunk=chunk,
                               init_state=state, plan=plan)
            assert torch.equal(got[0], want[0]), plan
            assert torch.equal(got[1], want[1]), plan


def test_reduced_mamba_on_cuda_matches_eager(card):
    cfg = reduced(get_arch("mamba2-1.3b"))
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=card).manual_seed(0), device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 75),
                           generator=torch.Generator().manual_seed(1)).to(card)
    engines = (make_engine("cuda"), make_engine("eager", device=card))
    before = ssd.launches
    with torch.inference_mode():
        got, want = (make_prefill_step(e, cfg)(params, tokens)
                     for e in engines)
        assert ssd.launches == before + cfg.n_layers
        assert _relmax(got[0], want[0]) <= 1e-4
        for name, t in want[1][0].items():
            assert _relmax(got[1][0][name], t) <= 1e-4, name
        tok = tokens[:, -1:]
        for _ in range(3):
            lg, _ = make_decode_step(engines[0], cfg)(params, got[1], tok, 0)
            lw, _ = make_decode_step(engines[1], cfg)(params, want[1], tok, 0)
            assert _relmax(lg, lw) <= 1e-4
            tok = lw[:, -1].argmax(-1, keepdim=True)


def test_slot_engine_on_cuda_prefills_through_the_ssd_kernel(card):
    cfg = reduced(get_arch("mamba2-1.3b"))
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=card).manual_seed(0), device=card)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                    max_new=4) for i, n in enumerate((40, 9, 17))]
    ssd.reset_launches()
    ServingEngine(cfg, params, slots=2, max_len=64).run(reqs)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert ssd.launches == 3 * cfg.n_layers


# (B, M, K, N): BMM_CASES of tests/test_grad_conformance.py, a ragged case
# and a tall one
BMM_CASES = [(2, 32, 16, 32), (3, 17, 23, 9), (5, 100, 70, 130),
             (2, 1000, 64, 48)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,m,k,n", BMM_CASES)
def test_bmm_kernels_match_plain_and_the_2d_kernels(card, b, m, k, n, dtype,
                                                    tol):
    gen = torch.Generator(device=card).manual_seed(b + m + k + n)
    x = torch.randn(b, m, k, generator=gen, device=card).to(dtype)
    w = (torch.randn(b, k, n, generator=gen, device=card) / k ** 0.5).to(
        dtype)
    dy = torch.randn(b, m, n, generator=gen, device=card).to(dtype)
    for plan, bplan in zip(gemm.PLANS, gemm.BWD_PLANS * 2):
        for splits in (1, 3):
            before = gemm.launch_counts()
            y = gemm.bmm_fwd(x, w, plan=plan)
            dx = gemm.bmm_bwd_dx(dy, w, plan=bplan, splits=splits)
            dw = gemm.bmm_bwd_dw(x, dy, plan=bplan, splits=splits)
            after = gemm.launch_counts()
            for name in ("bmm_fwd", "bmm_bwd_dx", "bmm_bwd_dw"):
                assert after[name] == before[name] + 1, name
            assert _relmax(y, gemm.bmm_fwd_plain(x, w)) <= tol
            assert _relmax(dx, gemm.bmm_bwd_dx_plain(dy, w)) <= tol
            assert _relmax(dw, gemm.bmm_bwd_dw_plain(x, dy)) <= tol
            assert torch.equal(dw, gemm.bmm_bwd_dw(x, dy, plan=bplan,
                                                   splits=splits))
            for i in range(b):
                assert torch.equal(y[i], gemm.gemm_fused_fwd(x[i], w[i],
                                                             plan=plan))
                assert torch.equal(dx[i], gemm.gemm_bwd_dx(
                    dy[i], w[i], plan=bplan, splits=splits))
                assert torch.equal(dw[i], gemm.gemm_bwd_dw(
                    x[i], dy[i], plan=bplan, splits=splits))


def test_engine_bmm_and_its_gradient_on_cuda_match_eager(card):
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(4, 96, 200, generator=gen, device=card)
    w = torch.randn(4, 200, 72, generator=gen, device=card) / 200 ** 0.5
    out = {}
    for name in ("cuda", "eager"):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = make_engine(name, device=card).bmm(xr, wr)
        out[name] = (y, *torch.autograd.grad((y ** 2).sum(), (xr, wr)))
    for got, want in zip(out["cuda"], out["eager"]):
        assert _relmax(got, want) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,h,w_,cin,kh,kw,cout,th", [
    (2, 16, 16, 3, 3, 3, 8, 7), (1, 10, 12, 4, 1, 1, 16, 8),
    (2, 12, 9, 2, 5, 3, 4, 4), (1, 9, 9, 8, 3, 3, 8, 8),
    (2, 30, 30, 70, 3, 3, 130, 8), (1, 20, 33, 16, 3, 3, 64, 1)])
def test_conv_direct_kernel_matches_plain_version(card, b, h, w_, cin, kh,
                                                  kw, cout, th, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(h + cin + cout)
    x = torch.randn(b, h, w_, cin, generator=gen, device=card).to(dtype)
    w = (torch.randn(kh, kw, cin, cout, generator=gen, device=card)
         / (kh * kw * cin) ** 0.5).to(dtype)
    want = conv_direct.conv2d_direct_plain(x, w)
    for plan in (None, *conv_direct.PLANS):
        before = conv_direct.launches
        got = conv_direct.conv2d_direct(x, w, th=th, plan=plan)
        again = conv_direct.conv2d_direct(x, w, th=th, plan=plan)
        torch.cuda.synchronize()
        assert conv_direct.launches == before + 2
        assert got.dtype == dtype
        assert got.shape == (b, h - kh + 1, w_ - kw + 1, cout)
        assert _relmax(got, want) <= tol, plan
        assert torch.equal(got, again), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w_,cin,k,cout", [
    (2, 37, 40, 3, 3, 32), (1, 23, 26, 5, 3, 48), (3, 19, 22, 12, 3, 32),
    (2, 23, 23, 12, 1, 48), (1, 16, 16, 64, 3, 128), (2, 9, 9, 40, 1, 256)])
def test_every_conv_plan_gives_the_path_plans_bits(card, b, h, w_, cin, k,
                                                   cout, dtype):
    gen = torch.Generator(device=card).manual_seed(b * h + cin)
    x = torch.randn(b, h, w_, cin, generator=gen, device=card).to(dtype)
    w = (torch.randn(k, k, cin, cout, generator=gen, device=card)
         / (k * k * cin) ** 0.5).to(dtype)
    want = conv_direct.conv2d_direct(x, w)
    for plan in conv_direct.PLANS:
        assert torch.equal(conv_direct.conv2d_direct(x, w, plan=plan),
                           want), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,lens", [
    (1, 64, 1024, 14, 2, 64, True, [576]),
    (2, 100, 130, 8, 1, 32, True, [130, 0]),
    (3, 5, 256, 16, 16, 128, False, [256, 100, 0]),
    (2, 300, 300, 14, 2, 64, True, None)])
def test_every_forward_plan_gives_the_path_plans_bits(card, b, sq, skv, h,
                                                      kv, d, causal, lens,
                                                      dtype):
    q, k, v = _qkv(card, b, sq, skv, h, kv, d, dtype, seed=9)
    kvl = (None if lens is None
           else torch.tensor(lens, dtype=torch.int32, device=card))
    want = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    want_o, want_lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                              return_lse=True)
    assert torch.equal(want_o, want)
    for plan in fa.PLANS:
        o = fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=plan)
        o2, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                         return_lse=True, plan=plan)
        assert torch.equal(o, want) and torch.equal(o2, want), plan
        assert torch.equal(lse, want_lse), plan
