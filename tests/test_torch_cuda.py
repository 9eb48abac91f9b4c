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
plan's.  For the modality frontends: the flash forward at head dim 80
against its plain version under every plan it admits (the 32-lane plan
refused), dQ and dK / dV at hubert's training shape against their plain
versions, the decode kernel refusing head dim 80, reduced
internvl2-2b's prefill, decode and slot-engine streams and reduced
hubert-xlarge's forward (at head dim 80) on `cuda` against `eager`.  For
the hybrid: the flash forward and the split-KV decode at zamba2's head dim
112 against their plain versions (every forward plan bit for bit the path
plan's, the one-split decode the forward's, the merge `combine`'s), dQ /
dK / dV at zamba2's training shape against their plain versions, and
reduced zamba2-7b (with a mamba tail, at head
dim 112) through prefill, decode and the slot engine on `cuda` against
`eager`.  For MLA: the flash forward at head dim 192 (the 32-lane plan
alone) and the split-KV decode at 576 (G = 16 over one latent kv-head,
K and V in half tiles) against their plain versions, the merge bit for
bit `combine`, the flash forward at 576 (K and V in half tiles) against
its plain version and bit for bit the one-split decode, the forward's
8-lane plans and dQ / dK / dV at 576 (and the 64-row dQ plan at 192)
refused with no launch, and reduced deepseek-v2-lite-16b at MLA's widths
through prefill, decode, a 12-token decode chunk and the slot engine
(against 256 and 24 cache rows) on `cuda` against `eager`.  For training the SSM, audio and hybrid families:
reduced mamba2-1.3b, hubert-xlarge at 80 and zamba2-7b at 112 through
`loss_fn` on `cuda` against `eager` (exact attention and SSD counts: the
einsum form under grad, the kernel in a prefill after), and the `cuda` ssd
dispatch following grad mode with and without remat.  For training the
MoE programs: dQ / dK / dV at MLA's 192 (the grid rows, deepseek's 2 x
512 training shape, `FlashAttention` through autograd) and the expert
bmm's dX and dW at deepseek-v2-lite's and llama4-scout's training shapes
against their plain versions, every backward plan and batch slice
bitwise.  For the measured autotuner: per op, the measured pick's
output bit for bit the heuristic pick's (matmul, bmm at its batch, the
backward GEMMs dx / dw / bdx / bdw, attention and its backward), a
positive device time per call for a kernel of a few microseconds, and a
second resolution in a simulated fresh process that times nothing.
"""
import dataclasses
import json

import pytest
import torch

import numpy as np

from repro_torch.configs.base import (ShapeConfig, get_arch, input_tensors,
                                      reduced)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG, SEGNET_SMALL_CFG
from repro_torch.core import autotune, backends, make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm, ops
from repro_torch.kernels import conv_direct, ssd
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import PagedServingEngine
from repro_torch.serve import kvcache
from repro_torch.serve.serve_step import (make_decode_step, make_forward_step,
                                          make_prefill_step)
from repro_torch.kernels.common import ACTIVATIONS, epilogue
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_cnn_train_step, make_train_step
from repro_torch.tree import flatten, unflatten_like

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
        got = make_prefill_step(make_engine("cuda"), cfg)(
            params, {"tokens": tokens})
        want = make_prefill_step(make_engine("eager", device=card), cfg)(
            params, {"tokens": tokens})
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
    (2, 70, 70, 16, 16, 80, False, [50, 0]),
    (2, 33, 130, 8, 2, 80, True, [130, 20]),
    (2, 100, 100, 4, 4, 112, True, None),
    (1, 40, 130, 8, 1, 112, False, [77]),
    (2, 70, 70, 16, 16, 192, True, [50, 0]),
    (1, 40, 130, 8, 2, 192, False, [77]),
    (2, 128, 128, 4, 4, 192, True, None),
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
    for plan in fa.bwd_plans_at(d):  # every plan gives the path plan's bits
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
        got, want = (make_prefill_step(e, cfg)(params, {"tokens": tokens})
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


# The expert bmm of the MoE training paths, (E, B x capacity, K, N):
# deepseek-v2-lite-16b's at 2 x 512 (64 experts, 2048 <-> 1408, capacity
# 64) and llama4-scout-17b-a16e's at 2 x 512 (16 experts, 5120 <-> 8192,
# capacity 40)
EXPERT_BWD_CASES = [(64, 128, 2048, 1408), (64, 128, 1408, 2048),
                    (16, 80, 5120, 8192), (16, 80, 8192, 5120)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,m,k,n", EXPERT_BWD_CASES)
def test_expert_bmm_backward_at_the_training_shapes(card, b, m, k, n, dtype,
                                                    tol):
    """dX and dW of the expert bmm at the path's plan and split
    (`ops.bwd_plan` with the batch) against their plain versions (the fp32
    bar grows with the square root of a contraction past 4096 terms, as
    chip_smoke.py's `gemm_tol`), every backward plan bitwise, every batch
    slice the 2-D kernel's, reruns bitwise."""
    gen = torch.Generator(device=card).manual_seed(b + m + k + n)
    x = torch.randn(b, m, k, generator=gen, device=card).to(dtype)
    w = (torch.randn(b, k, n, generator=gen, device=card) / k ** 0.5).to(
        dtype)
    dy = torch.randn(b, m, n, generator=gen, device=card).to(dtype)
    (tx, sx), (tw, sw) = ops.bwd_plan("dx", m, n, k, b), ops.bwd_plan(
        "dw", k, m, n, b)
    dx = gemm.bmm_bwd_dx(dy, w, plan=tx, splits=sx)
    dw = gemm.bmm_bwd_dw(x, dy, plan=tw, splits=sw)
    for got, want, kdim in ((dx, gemm.bmm_bwd_dx_plain(dy, w), n),
                            (dw, gemm.bmm_bwd_dw_plain(x, dy), m)):
        bar = tol * (max(1.0, (kdim / 4096) ** 0.5) if dtype ==
                     torch.float32 else 1.0)
        assert bool(torch.isfinite(got).all())
        assert _relmax(got, want) <= bar
    assert torch.equal(dx, gemm.bmm_bwd_dx(dy, w, plan=tx, splits=sx))
    assert torch.equal(dw, gemm.bmm_bwd_dw(x, dy, plan=tw, splits=sw))
    for plan in gemm.BWD_PLANS:
        assert torch.equal(dx, gemm.bmm_bwd_dx(dy, w, plan=plan, splits=sx))
        assert torch.equal(dw, gemm.bmm_bwd_dw(x, dy, plan=plan, splits=sw))
    for i in range(b):
        assert torch.equal(dx[i], gemm.gemm_bwd_dx(dy[i], w[i], plan=tx,
                                                   splits=sx))
        assert torch.equal(dw[i], gemm.gemm_bwd_dw(x[i], dy[i], plan=tw,
                                                   splits=sw))


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


@pytest.mark.parametrize("spec,xs,ws", [
    ("becd,edf->becf", (2, 4, 8, 64), (4, 64, 96)),
    ("becf,efd->becd", (3, 4, 8, 96), (4, 96, 64))])
def test_cuda_einsum_runs_the_bmm_kernel(card, spec, xs, ws):
    """A MoE expert einsum on `cuda` is one bmm launch, within 1e-5 of
    `eager`; a spec that is no batched GEMM raises instead of running a
    library einsum."""
    gen = torch.Generator(device=card).manual_seed(31)
    x = torch.randn(xs, generator=gen, device=card)
    w = torch.randn(ws, generator=gen, device=card) / ws[1] ** 0.5
    cuda, eager = make_engine("cuda"), make_engine("eager", device=card)
    before = gemm.launches_bmm
    got = cuda.einsum(spec, x, w)
    assert gemm.launches_bmm == before + 1
    assert _relmax(got, eager.einsum(spec, x, w)) <= 1e-5
    with pytest.raises(NotImplementedError, match="bqhd"):
        cuda.einsum("bqhd,bkhd->bhqk", x, x)


def test_reduced_llama4_on_cuda_matches_eager(card):
    """Reduced llama4-scout on `cuda` against `eager`: prefill logits and a
    decode step within 1e-4, three expert bmm launches a layer and call;
    the slot engine's streams on `cuda` equal `eager`'s."""
    cfg = reduced(get_arch("llama4-scout-17b-a16e"))
    gen = torch.Generator(device=card).manual_seed(32)
    params = tfm.init_params(cfg, generator=gen, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                           device=card)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=card)
            before = gemm.launches_bmm
            logits, caches = make_prefill_step(eng, cfg)(
                params, {"tokens": tokens})
            dlogits, _ = make_decode_step(eng, cfg)(
                params, caches, tokens[:, -1:], torch.tensor(23, device=card))
            out[label] = (logits, dlogits, gemm.launches_bmm - before)
    assert out["cuda"][2] == 2 * 3 * cfg.n_layers
    assert out["eager"][2] == 0
    assert _relmax(out["cuda"][0], out["eager"][0]) <= 1e-4
    assert _relmax(out["cuda"][1], out["eager"][1]) <= 1e-4
    streams = []
    for label in ("cuda", "eager"):
        rng = np.random.default_rng(33)
        reqs = [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, int(rng.integers(3, 12))).tolist(),
            max_new=5) for i in range(5)]
        ServingEngine(cfg, params, engine=make_engine(label, device=card),
                      slots=2, max_len=64).run(reqs)
        streams.append([r.out for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,h,kv,causal,lens", [
    (4, 50, 50, 16, 16, False, None),
    (2, 37, 100, 8, 2, True, [100, 0]),
    (1, 1, 64, 4, 1, False, [40]),
    (3, 130, 130, 4, 4, True, [130, 60, 1])])
def test_forward_at_head_dim_80_matches_plain_under_every_plan(
        card, b, sq, skv, h, kv, causal, lens, dtype, tol):
    """The flash forward at head dim 80 (10 columns a lane: runs of 4, 4
    and a tail of 2) against its plain version, dead rows exact 0, every
    plan it admits (and the lse launch) bit for bit the path plan's; the
    32-lane plan is refused by name, before any launch."""
    q, k, v = _qkv(card, b, sq, skv, h, kv, 80, dtype, seed=21)
    kvl = (None if lens is None
           else torch.tensor(lens, dtype=torch.int32, device=card))
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, kvl, causal=causal)
    assert _relmax(got, want) <= tol
    if lens is not None and 0 in lens:
        assert bool((got[lens.index(0)] == 0).all())
    o_lse, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                        return_lse=True)
    assert torch.equal(o_lse, got)
    for plan in fa.plans_at(80):
        assert torch.equal(fa.flash_attention_fwd(
            q, k, v, kvl, causal=causal, plan=plan), got), plan
        o2, lse2 = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                          return_lse=True, plan=plan)
        assert torch.equal(o2, got) and torch.equal(lse2, lse), plan
    before = fa.launch_counts()
    with pytest.raises(ValueError, match="head dim 80"):
        fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=fa.PLANS[2])
    assert fa.launch_counts() == before


def _bwd_at_model_shape(card, b, s, h, d, causal, seed):
    """dQ and dK / dV against their plain versions at a model's training
    shape (MHA, G = 1), fp32, and every dQ plan bit for bit the path's."""
    q, k, v = _qkv(card, b, s, s, h, h, d, seed=seed)
    do = torch.randn(q.shape, device=card)
    o, lse = fa.flash_attention_fwd(q, k, v, None, causal=causal,
                                    return_lse=True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, None)
    dq = fa.flash_attention_bwd_dq(*args, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal=causal)
    want = (fa.flash_attention_bwd_dq_plain(*args, causal=causal),
            *fa.flash_attention_bwd_dkv_plain(*args, causal=causal))
    for got, w in zip((dq, dk, dv), want):
        assert _relmax(got, w) <= 1e-5
    for plan in fa.bwd_plans_at(d):
        assert torch.equal(dq, fa.flash_attention_bwd_dq(
            *args, causal=causal, plan=plan))


def test_head_dim_80_on_the_card_backward_and_decode(card):
    """hubert-xlarge's training shape (4 x 500, 16 / 16 heads of 80, not
    causal): dQ and dK / dV against their plain versions, every dQ plan
    bitwise; the split-KV decode kernel, not instantiated at 80, refuses
    it by name with no launch."""
    _bwd_at_model_shape(card, 4, 500, 16, 80, False, seed=22)
    q, k, v = _qkv(card, 2, 4, 256, 4, 2, 80, seed=22)
    kvl = torch.tensor([256, 100], dtype=torch.int32, device=card)
    before = (fa.launch_counts(), fd.launches)
    for call in (lambda: fd.flash_decode(q, k, v, kvl, causal=False,
                                         n_splits=4, span=64),
                 lambda: fd.flash_decode_partials(q, k, v, kvl, causal=False,
                                                  n_splits=4, span=64),
                 lambda: ops.attention_decode(q, k, v, kvl)):
        with pytest.raises(ValueError, match="head dim 80"):
            call()
    assert (fa.launch_counts(), fd.launches) == before


def _frontend_params(cfg, card, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, device=card)
    with torch.no_grad():
        for name, t in params["frontend"].items():
            if name.startswith("b"):
                t.copy_(torch.randn(t.shape, generator=gen, device=card))
    return params, gen


def test_reduced_internvl2_on_cuda_matches_eager(card):
    """Reduced internvl2-2b (8 patch embeddings before 24 text tokens) on
    `cuda` against `eager`: the prefill's logits and caches and a decode
    step against 256 cache rows (the split-KV kernel) within 1e-4, with
    the projector's two GEMMs launched; the slot engine's text-only
    streams on `cuda` equal `eager`'s."""
    cfg = reduced(get_arch("internvl2-2b"))
    params, gen = _frontend_params(cfg, card, 34)
    inputs = input_tensors(cfg, ShapeConfig("p", 32, 2, "prefill"),
                           generator=gen, device=card)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=card)
            before = (gemm.launches, fa.launches, fd.launches)
            logits, caches = make_prefill_step(eng, cfg)(params, inputs)
            buf = kvcache.cache_init(cfg, 2, 256, device=card)
            kvcache.copy_prefill(cfg, buf, caches, 32)
            dlogits, _ = make_decode_step(eng, cfg)(
                params, buf, inputs["tokens"][:, -1:],
                torch.tensor(32, device=card))
            after = (gemm.launches, fa.launches, fd.launches)
            out[label] = (logits, caches, dlogits,
                          tuple(a - b for a, b in zip(after, before)))
    n = cfg.n_layers
    assert out["cuda"][3] == (2 * 7 * n + 2 + 2, n, n)
    assert out["eager"][3] == (0, 0, 0)
    assert _relmax(out["cuda"][0], out["eager"][0]) <= 1e-4
    assert _relmax(out["cuda"][1][0]["k"], out["eager"][1][0]["k"]) <= 1e-4
    assert _relmax(out["cuda"][2], out["eager"][2]) <= 1e-4
    streams = []
    for label in ("cuda", "eager"):
        rng = np.random.default_rng(35)
        reqs = [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, int(rng.integers(3, 12))).tolist(),
            max_new=5) for i in range(5)]
        ServingEngine(cfg, params, engine=make_engine(label, device=card),
                      slots=2, max_len=64).run(reqs)
        streams.append([r.out for r in reqs])
    assert streams[0] == streams[1]


def test_reduced_hubert_at_head_dim_80_on_cuda_matches_eager(card):
    """Reduced hubert-xlarge with its head dim of 80 (4 MHA heads, frames
    of 64) through `make_forward_step` on `cuda` against `eager`: logits
    within 1e-4, one flash-forward launch a layer, not causal; the slot
    engine refuses it."""
    cfg = dataclasses.replace(reduced(get_arch("hubert-xlarge")),
                              head_dim=80)
    params, gen = _frontend_params(cfg, card, 36)
    inputs = input_tensors(cfg, ShapeConfig("a", 75, 3, "prefill"),
                           generator=gen, device=card)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            before = (gemm.launches, fa.launches)
            logits = make_forward_step(make_engine(label, device=card), cfg)(
                params, inputs)
            out[label] = (logits, (gemm.launches - before[0],
                                   fa.launches - before[1]))
    assert out["cuda"][1] == (6 * cfg.n_layers + 2, cfg.n_layers)
    assert out["eager"][1] == (0, 0)
    assert _relmax(out["cuda"][0], out["eager"][0]) <= 1e-4
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, params, engine=make_engine("cuda"))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,h,kv,causal,lens", [
    (2, 64, 64, 32, 32, True, None),
    (2, 37, 100, 8, 2, True, [100, 0]),
    (1, 1, 64, 4, 4, False, [40]),
    (3, 130, 130, 4, 4, False, [130, 60, 1])])
def test_forward_at_head_dim_112_matches_plain_under_every_plan(
        card, b, sq, skv, h, kv, causal, lens, dtype, tol):
    """The flash forward at zamba2's head dim 112 (14 columns a lane:
    runs of 4, 4, 4 and a tail of 2) against its plain version, dead rows
    exact 0, every plan it admits (and the lse launch) bit for bit the path
    plan's; the 32-lane plan is refused by name, before any launch."""
    q, k, v = _qkv(card, b, sq, skv, h, kv, 112, dtype, seed=31)
    kvl = (None if lens is None
           else torch.tensor(lens, dtype=torch.int32, device=card))
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    assert fa.launches == before + 1
    assert _relmax(got, fa.flash_attention_plain(q, k, v, kvl,
                                                 causal=causal)) <= tol
    if lens is not None and 0 in lens:
        assert bool((got[lens.index(0)] == 0).all())
    o_lse, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                        return_lse=True)
    assert torch.equal(o_lse, got)
    for plan in fa.plans_at(112):
        assert torch.equal(fa.flash_attention_fwd(
            q, k, v, kvl, causal=causal, plan=plan), got), plan
    before = fa.launch_counts()
    with pytest.raises(ValueError, match="head dim 112"):
        fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=fa.PLANS[2])
    assert fa.launch_counts() == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,h,kv,lens", [
    (2, 1, 528, 32, 32, [513, 528]),
    (4, 1, 256, 4, 4, [256, 85, 1, 0]),
    (3, 4, 1024, 8, 2, [1024, 341, 0])])
def test_decode_at_head_dim_112_matches_plain_and_the_forward(
        card, b, sq, skv, h, kv, lens, dtype, tol):
    """The split-KV decode at head dim 112 (28 lanes of one float4 in
    P V): its partials against the plain version, the merged launch bit
    for bit `combine`, and at one split the forward kernel's bits."""
    q, k, v = _qkv(card, b, sq, skv, h, kv, 112, dtype, seed=32)
    kvl = torch.tensor(lens, dtype=torch.int32, device=card)
    causal = sq > 1
    ns, span = ops.decode_splits(skv, kv)
    parts = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                     n_splits=ns, span=span)
    want = fd.flash_decode_plain(q, k, v, kvl, causal=causal, n_splits=ns,
                                 span=span)
    assert _relmax(parts[0], want[0]) <= tol
    assert _relmax(parts[1], want[1]) <= tol
    merged, o_part, lse_part = fd.flash_decode(q, k, v, kvl, causal=causal,
                                               n_splits=ns, span=span)
    assert torch.equal(o_part, parts[0]) and torch.equal(lse_part, parts[1])
    assert torch.equal(merged, fd.merge_plain(*parts, q.dtype))
    one, _ = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                      n_splits=1, span=-(-skv // 64) * 64)
    assert torch.equal(one[:, :, 0].transpose(1, 2).to(q.dtype),
                       fa.flash_attention_fwd(q, k, v, kvl, causal=causal))


def test_head_dim_112_on_the_card_backward_and_192_refused(card):
    """zamba2-7b's training shape (2 x 512, 32 / 32 heads of 112, causal):
    dQ and dK / dV against their plain versions, every dQ plan bitwise;
    then what the backward still refuses, with no launch: the 64-row dQ
    plan at MLA's 192 (the test's name is from when 192 was refused
    whole) and dQ, dK / dV and `FlashAttention` at the latent's 576."""
    _bwd_at_model_shape(card, 2, 512, 32, 112, True, seed=33)
    q, k, v = _qkv(card, 2, 4, 64, 4, 4, 576, seed=33)
    q2, k2, v2 = _qkv(card, 2, 4, 64, 4, 4, 192, seed=33)
    lse = torch.zeros(2, 4, 4, device=card)
    before = fa.launch_counts()
    for call in (lambda: fa.flash_attention_bwd_dq(q, k, v, q, lse, lse),
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, q, lse, lse),
                 lambda: fa.FlashAttention.apply(q.requires_grad_(), k, v,
                                                 None, True)):
        with pytest.raises(ValueError, match="head dim 576"):
            call()
    with pytest.raises(ValueError, match="head dim 192"):
        fa.flash_attention_bwd_dq(q2, k2, v2, q2, lse, lse,
                                  plan=fa.BWD_PLANS[0])
    assert fa.launch_counts() == before


def test_head_dim_192_on_the_card_backward(card):
    """deepseek-v2-lite-16b's training shape (2 x 512, 16 / 16 heads of
    192, causal): dQ and dK / dV against their plain versions under the
    one dQ plan at 192, and `FlashAttention` through autograd against the
    plain forward's autograd."""
    _bwd_at_model_shape(card, 2, 512, 16, 192, True, seed=34)
    q, k, v = (t.requires_grad_() for t in _qkv(card, 1, 64, 64, 4, 4, 192,
                                                seed=35))
    o = fa.FlashAttention.apply(q, k, v, None, True)
    got = torch.autograd.grad(o.square().sum(), (q, k, v))
    ref = fa.flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for g, w in zip(got, want):
        assert _relmax(g, w) <= 1e-5


def _zamba2_small(card):
    """Reduced zamba2-7b with a one-layer mamba tail (2 super entries of 2
    mamba layers and the shared block, then 1 mamba layer) at zamba2's
    head dim 112, random from a seed with the mixers' dt bias, A and D
    moved off their init."""
    cfg = dataclasses.replace(reduced(get_arch("zamba2-7b")), n_layers=5,
                              head_dim=112)
    gen = torch.Generator(device=card).manual_seed(37)
    params = tfm.init_params(cfg, generator=gen, device=card)
    with torch.no_grad():
        for lp in params["layers"]:
            for name in ("dt_bias", "A_log", "D"):
                t = lp["mixer"][name]
                t.add_(torch.randn(t.shape, generator=gen, device=card) * 0.3)
    return cfg, params


def test_reduced_zamba2_on_cuda_matches_eager(card):
    """Reduced zamba2-7b (a super entry's program and a tail) on `cuda`
    against `eager`: the prefill's logits and every cache leaf, then three
    decode steps against 256 cache rows (the shared block on the split-KV
    kernel at head dim 112), within 1e-4; per prefill one SSD launch a
    mamba layer and one flash forward a super entry, per step one
    split-KV launch a super entry."""
    cfg, params = _zamba2_small(card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 75),
                           generator=torch.Generator().manual_seed(38)
                           ).to(card)
    n_super = tfm.stack_program(cfg)[0][1]
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=card)
            before = (ssd.launches, fa.launches, fd.launches)
            logits, caches = make_prefill_step(eng, cfg)(params,
                                                         {"tokens": tokens})
            buf = kvcache.cache_init(cfg, 2, 256, device=card)
            kvcache.copy_prefill(cfg, buf, caches, 75)
            dlogits = []
            for i in range(3):  # both fed the same tokens
                lg, buf = make_decode_step(eng, cfg)(
                    params, buf, tokens[:, i:i + 1], 75 + i)
                dlogits.append(lg)
            after = (ssd.launches, fa.launches, fd.launches)
            out[label] = (logits, caches, torch.stack(dlogits), buf,
                          tuple(a - b for a, b in zip(after, before)))
    assert out["cuda"][4] == (cfg.n_layers, n_super, 3 * n_super)
    assert out["eager"][4] == (0, 0, 0)
    assert _relmax(out["cuda"][0], out["eager"][0]) <= 1e-4
    assert _relmax(out["cuda"][2], out["eager"][2]) <= 1e-4
    for name, t in flatten(out["eager"][1]).items():
        assert _relmax(flatten(out["cuda"][1])[name], t) <= 1e-4, name
    for name, t in flatten(out["eager"][3]).items():
        assert _relmax(flatten(out["cuda"][3])[name], t) <= 1e-4, name


def test_slot_engine_on_cuda_serves_zamba2_through_the_kernels(card):
    """The slot engine on `cuda` serves reduced zamba2-7b: every prompt is
    prefilled through the SSD kernel and the flash forward, every step's
    shared block runs the split-KV kernel (256 cache rows), a reused
    slot's stream equals the request alone, and the streams equal the
    slot engine's on `eager`."""
    cfg, params = _zamba2_small(card)
    n_super = tfm.stack_program(cfg)[0][1]

    def reqs():
        rng = np.random.default_rng(39)
        return [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, int(rng.integers(3, 40))).tolist(),
            max_new=5) for i in range(5)]

    streams = []
    for label in ("cuda", "eager"):
        rs = reqs()
        before = (ssd.launches, fa.launches, fd.launches)
        eng = ServingEngine(cfg, params, engine=make_engine(
            label, device=card), slots=2, max_len=256)
        eng.run(rs)
        after = (ssd.launches, fa.launches, fd.launches)
        assert all(r.done and len(r.out) == 5 for r in rs)
        if label == "cuda":
            steps = eng.stats()["steps"]
            assert tuple(a - b for a, b in zip(after, before)) == (
                5 * cfg.n_layers, 5 * n_super, steps * n_super)
        streams.append([r.out for r in rs])
    assert streams[0] == streams[1]
    alone = reqs()[2]
    ServingEngine(cfg, params, engine=make_engine("cuda"), slots=1,
                  max_len=256).run([alone])
    assert alone.out == streams[0][2]


# -------------------------------------------------------------- MLA ---

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,causal,lens", [
    (2, 512, 512, True, None),
    (1, 16, 16, True, None),
    (2, 100, 130, True, [130, 0]),
    (2, 64, 200, False, [150, 64])])
def test_forward_at_head_dim_192_matches_plain(card, b, sq, skv, causal,
                                               lens, dtype, tol):
    """The flash forward at MLA's prefill head dim 192 (16 / 16 heads; the
    32-lane plan, 6 columns a lane) against its plain version, dead rows
    exact 0, the lse launch's o and every admitted plan bit for bit the
    path plan's; the 8-lane plans refused by name with no launch."""
    q, k, v = _qkv(card, b, sq, skv, 16, 16, 192, dtype, seed=41)
    kvl = (None if lens is None
           else torch.tensor(lens, dtype=torch.int32, device=card))
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    assert fa.launches == before + 1
    assert _relmax(got, fa.flash_attention_plain(q, k, v, kvl,
                                                 causal=causal)) <= tol
    if lens is not None and 0 in lens:
        assert bool((got[lens.index(0)] == 0).all())
    o_lse, _ = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                      return_lse=True)
    assert torch.equal(o_lse, got)
    assert fa.plans_at(192) == (fa.PLANS[2],)
    for plan in fa.plans_at(192):
        assert torch.equal(fa.flash_attention_fwd(
            q, k, v, kvl, causal=causal, plan=plan), got), plan
    before = fa.launch_counts()
    for plan in fa.PLANS[:2]:
        with pytest.raises(ValueError, match="head dim 192"):
            fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=plan)
    assert fa.launch_counts() == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,lens", [
    (2, 1, 528, [528, 300]),
    (4, 1, 256, [256, 85, 1, 0]),
    (3, 4, 1024, [1024, 341, 0]),
    (1, 8, 256, [256]),
    (2, 1, 3000, [3000, 2900])])
def test_decode_at_head_dim_576_matches_plain_and_combine(
        card, b, sq, skv, lens, dtype, tol):
    """The split-KV decode at MLA's latent head dim 576 (16 query heads
    over one kv-head; K and V through 32-key half tiles): its partials
    and the empty-span sentinels against the plain version, the merged
    launch's partials the partials-only launch's and its output bit for
    bit `combine`'s (up to 47 splits)."""
    q, k, v = _qkv(card, b, sq, skv, 16, 1, 576, dtype, seed=42)
    kvl = torch.tensor(lens, dtype=torch.int32, device=card)
    causal = sq > 1
    ns, span = ops.decode_splits(skv, 1)
    assert ns <= fd.MERGE_MAX_SPLITS
    parts = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                     n_splits=ns, span=span)
    want = fd.flash_decode_plain(q, k, v, kvl, causal=causal, n_splits=ns,
                                 span=span)
    assert _relmax(parts[0], want[0]) <= tol
    assert _relmax(parts[1], want[1]) <= tol
    empty = parts[1] == fd.EMPTY_SPAN_LSE
    assert torch.equal(empty, want[1] == fd.EMPTY_SPAN_LSE)
    assert bool((parts[0][empty] == 0).all())
    merged, o_part, lse_part = fd.flash_decode(q, k, v, kvl, causal=causal,
                                               n_splits=ns, span=span)
    assert torch.equal(o_part, parts[0]) and torch.equal(lse_part, parts[1])
    assert torch.equal(merged, fd.merge_plain(*parts, q.dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,sq,skv,causal,lens", [
    (4, 1, 128, False, [128, 42, 1, 0]),
    (2, 64, 128, True, [128, 64]),
    (2, 12, 100, True, [100, 0]),
    (3, 5, 70, False, None)])
def test_forward_at_head_dim_576_matches_plain_and_the_decode(
        card, b, sq, skv, causal, lens, dtype, tol):
    """The flash forward at MLA's latent head dim 576 (16 query heads
    over one kv-head; K and V through 32-key half tiles, the 32-lane plan,
    18 columns a lane) against its plain version, dead rows exact 0, the
    lse launch's o and every admitted plan bit for bit the path plan's,
    the 8-lane plans refused by name with no launch; and the split-KV
    decode at one split bit for bit the forward."""
    q, k, v = _qkv(card, b, sq, skv, 16, 1, 576, dtype, seed=48)
    kvl = (None if lens is None
           else torch.tensor(lens, dtype=torch.int32, device=card))
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    assert fa.launches == before + 1
    assert _relmax(got, fa.flash_attention_plain(q, k, v, kvl,
                                                 causal=causal)) <= tol
    if lens is not None and 0 in lens:
        assert bool((got[lens.index(0)] == 0).all())
    o_lse, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                        return_lse=True)
    assert torch.equal(o_lse, got)
    _, want_lse = fa.flash_attention_plain(q, k, v, kvl, causal=causal,
                                           return_lse=True)
    assert _relmax(lse, want_lse) <= tol
    assert fa.plans_at(576) == (fa.PLANS[2],)
    for plan in fa.plans_at(576):
        o2, lse2 = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                          return_lse=True, plan=plan)
        assert torch.equal(fa.flash_attention_fwd(
            q, k, v, kvl, causal=causal, plan=plan), got), plan
        assert torch.equal(o2, got) and torch.equal(lse2, lse), plan
    before = fa.launch_counts()
    for plan in fa.PLANS[:2]:
        with pytest.raises(ValueError, match="head dim 576"):
            fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=plan)
    assert fa.launch_counts() == before
    dkvl = (torch.full((b,), skv, dtype=torch.int32, device=card)
            if kvl is None else kvl)
    one, _ = fd.flash_decode_partials(q, k, v, dkvl, causal=causal,
                                      n_splits=1, span=-(-skv // 64) * 64)
    assert torch.equal(one[:, :, 0].transpose(1, 2).to(q.dtype), got)


def test_kernels_refuse_mla_head_dims_they_lack_on_the_card(card):
    """The forward's 8-lane plans at 576 (their blocks do not fit; the
    test's name is from when the forward refused 576 whole), dQ / dK / dV
    at 576, and the 64-row dQ plan at 192, raise by name before any
    launch."""
    q, k, v = _qkv(card, 2, 4, 300, 16, 1, 576, seed=43)
    q2, k2, v2 = _qkv(card, 2, 4, 64, 4, 4, 192, seed=44)
    lse = torch.zeros(2, 16, 4, device=card)
    lse2 = torch.zeros(2, 4, 4, device=card)
    before = fa.launch_counts()
    for call in (lambda: fa.flash_attention_fwd(q, k, v, plan=fa.PLANS[0]),
                 lambda: fa.flash_attention_fwd(q, k, v, plan=fa.PLANS[1]),
                 lambda: fa.flash_attention_bwd_dq(q, k, v, q, lse, lse),
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, q, lse, lse),
                 lambda: fa.FlashAttention.apply(q.requires_grad_(), k, v,
                                                 None, True)):
        with pytest.raises(ValueError, match="head dim 576"):
            call()
    with pytest.raises(ValueError, match="head dim 192"):
        fa.flash_attention_bwd_dq(q2, k2, v2, q2, lse2, lse2,
                                  plan=fa.BWD_PLANS[0])
    assert fa.launch_counts() == before


def _deepseek_small(card):
    """Reduced deepseek-v2-lite-16b (a `mla_dense` and a `mla_moe` layer,
    d 128, 4 heads, 4 experts) at MLA's own widths: nope 128 and rope 64
    (the prefill at head dim 192), a latent of 512 (the decode at 576),
    v 128; random from a seed, the latent norm's scale off 1."""
    cfg = dataclasses.replace(reduced(get_arch("deepseek-v2-lite-16b")),
                              qk_nope_dim=128, qk_rope_dim=64,
                              kv_lora_rank=512, v_head_dim=128,
                              head_dim=192)
    gen = torch.Generator(device=card).manual_seed(45)
    params = tfm.init_params(cfg, generator=gen, device=card)
    with torch.no_grad():
        for lp in params["layers"]:
            t = lp["attn"]["kv_norm"]["scale"]
            t.add_(torch.randn(t.shape, generator=gen, device=card) * 0.1)
    return cfg, params


def test_reduced_mla_on_cuda_matches_eager(card):
    """Reduced deepseek-v2-lite-16b on `cuda` against `eager`: the
    prefill's logits and latent caches, then three decode steps against
    256 cache rows, within 1e-4; per prefill one flash forward a layer at
    (192, causal), per step one split-KV launch a layer at 576 and the
    two absorbed einsums a layer on the bmm kernel (with the expert
    GEMMs)."""
    cfg, params = _deepseek_small(card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 75),
                           generator=torch.Generator().manual_seed(46)
                           ).to(card)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=card)
            before = (fa.launches, fd.launches, gemm.launches_bmm)
            logits, caches = make_prefill_step(eng, cfg)(params,
                                                         {"tokens": tokens})
            mid = (fa.launches, fd.launches, gemm.launches_bmm)
            buf = kvcache.cache_init(cfg, 2, 256, device=card)
            kvcache.copy_prefill(cfg, buf, caches, 75)
            dlogits = []
            for i in range(3):  # both fed the same tokens
                lg, buf = make_decode_step(eng, cfg)(
                    params, buf, tokens[:, i:i + 1], 75 + i)
                dlogits.append(lg)
            after = (fa.launches, fd.launches, gemm.launches_bmm)
            out[label] = (logits, caches, torch.stack(dlogits), buf,
                          tuple(a - b for a, b in zip(mid, before)),
                          tuple(a - b for a, b in zip(after, mid)))
    assert out["cuda"][4] == (cfg.n_layers, 0, 3 * n_moe)
    assert out["cuda"][5] == (0, 3 * cfg.n_layers,
                              3 * (2 * cfg.n_layers + 3 * n_moe))
    assert out["eager"][4] == out["eager"][5] == (0, 0, 0)
    assert _relmax(out["cuda"][0], out["eager"][0]) <= 1e-4
    assert _relmax(out["cuda"][2], out["eager"][2]) <= 1e-4
    for name, t in flatten(out["eager"][1]).items():
        assert _relmax(flatten(out["cuda"][1])[name], t) <= 1e-4, name
    for name, t in flatten(out["eager"][3]).items():
        assert _relmax(flatten(out["cuda"][3])[name], t) <= 1e-4, name


def test_slot_engine_on_cuda_serves_mla_through_the_kernels(card):
    """The slot engine on `cuda` serves reduced deepseek-v2-lite-16b on
    the replay route against 256 cache rows: every step's attention on
    the split-KV kernel at 576, a reused slot's stream equal to the
    request alone, the streams equal to the slot engine's on `eager`."""
    cfg, params = _deepseek_small(card)

    def reqs():
        rng = np.random.default_rng(47)
        return [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, int(rng.integers(3, 12))).tolist(),
            max_new=4) for i in range(5)]

    streams = []
    for label in ("cuda", "eager"):
        rs = reqs()
        before = (fa.launches, fd.launches)
        eng = ServingEngine(cfg, params, engine=make_engine(
            label, device=card), slots=2, max_len=256)
        eng.run(rs)
        after = (fa.launches, fd.launches)
        assert all(r.done and len(r.out) == 4 for r in rs)
        if label == "cuda":
            steps = eng.stats()["steps"]
            assert (after[0] - before[0], after[1] - before[1]) == (
                0, steps * cfg.n_layers)
        streams.append([r.out for r in rs])
    assert streams[0] == streams[1]
    alone = reqs()[2]
    ServingEngine(cfg, params, engine=make_engine("cuda"), slots=1,
                  max_len=256).run([alone])
    assert alone.out == streams[0][2]


def test_slot_engine_on_cuda_serves_mla_on_short_caches(card):
    """The slot engine on `cuda` serves reduced deepseek-v2-lite-16b at
    MLA's widths against 24 cache rows (under the split-KV kernel's 256):
    every step's attention is the flash forward at 576, one launch a
    layer, no split-KV launch; a reused slot's stream equals the request
    alone and the streams equal the slot engine's on `eager`."""
    cfg, params = _deepseek_small(card)

    def reqs():
        rng = np.random.default_rng(49)
        return [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, int(rng.integers(3, 12))).tolist(),
            max_new=4) for i in range(5)]

    streams = []
    for label in ("cuda", "eager"):
        rs = reqs()
        before = (fa.launches, fd.launches)
        eng = ServingEngine(cfg, params, engine=make_engine(
            label, device=card), slots=2, max_len=24)
        eng.run(rs)
        after = (fa.launches, fd.launches)
        assert all(r.done and len(r.out) == 4 for r in rs)
        if label == "cuda":
            steps = eng.stats()["steps"]
            assert (after[0] - before[0], after[1] - before[1]) == (
                steps * cfg.n_layers, 0)
        streams.append([r.out for r in rs])
    assert streams[0] == streams[1]
    alone = reqs()[2]
    ServingEngine(cfg, params, engine=make_engine("cuda"), slots=1,
                  max_len=24).run([alone])
    assert alone.out == streams[0][2]


def test_mla_decode_chunk_on_cuda_matches_eager(card):
    """A 12-token chunk of the absorbed decode (past `ops.DECODE_MAX_SQ`)
    of reduced deepseek-v2-lite-16b at MLA's widths on `cuda` against
    `eager`, at positions 0 and 12 of 256-row latent caches: one causal
    flash forward a layer at 576 and no split-KV launch a chunk; logits
    and caches within 1e-4."""
    cfg, params = _deepseek_small(card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(50)
                           ).to(card)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=card)
            step = make_decode_step(eng, cfg)
            buf = kvcache.cache_init(cfg, 2, 256, device=card)
            before = (fa.launches, fd.launches)
            logits = []
            for pos in (0, 12):
                lg, buf = step(params, buf, tokens[:, pos:pos + 12], pos)
                logits.append(lg[..., :cfg.vocab_size])
            after = (fa.launches, fd.launches)
            out[label] = (torch.stack(logits), buf,
                          tuple(a - b for a, b in zip(after, before)))
    assert out["cuda"][2] == (2 * cfg.n_layers, 0)
    assert out["eager"][2] == (0, 0)
    assert _relmax(out["cuda"][0], out["eager"][0]) <= 1e-4
    for name, t in flatten(out["eager"][1]).items():
        assert _relmax(flatten(out["cuda"][1])[name], t) <= 1e-4, name


def _family_small(card, name):
    """(cfg, params, batch) of a reduced training config on the card:
    mamba2-1.3b (2 layers, 80 tokens: three SSD chunks of 32, the last
    ragged), hubert-xlarge at head dim 80 (normal frames) or zamba2-7b at
    head dim 112 with a mamba tail (`_zamba2_small`)."""
    if name == "zamba2_112_tail":
        cfg, params = _zamba2_small(card)
    else:
        cfg = reduced(get_arch("mamba2-1.3b" if name == "mamba2"
                               else "hubert-xlarge"))
        if name == "hubert_80":
            cfg = dataclasses.replace(cfg, head_dim=80)
        params = tfm.init_params(cfg, generator=torch.Generator(
            device=card).manual_seed(47), device=card)
    shape = ShapeConfig("t", 80 if name == "mamba2" else 48, 2, "train")
    batch = input_tensors(cfg, shape, generator=torch.Generator(
        device=card).manual_seed(48), device=card)
    return cfg, params, batch


@pytest.mark.parametrize("name", ["mamba2", "hubert_80", "zamba2_112_tail"])
def test_reduced_family_loss_gradients_on_cuda_match_eager(card, name):
    """`loss_fn` (remat) and every gradient on `cuda` against `eager`: the
    loss within 1e-5, gradients within 1e-4; per mamba layer two SSD
    dispatches in the einsum form (the forward and its recompute) and no
    SSD launch, per attention layer two lse forwards, one dQ and one dK /
    dV; a `no_grad` prefill afterwards launches the SSD kernel once a mamba
    layer."""
    cfg, params, batch = _family_small(card, name)
    out = {}
    for label in ("cuda", "eager"):
        leaves = {k: p.detach().clone().requires_grad_()
                  for k, p in flatten(params).items()}
        fa.reset_launches()
        ssd.reset_launches()
        loss = tfm.loss_fn(make_engine(label, device=card), cfg,
                           unflatten_like(leaves, params), batch,
                           ce_chunk=16)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        out[label] = (loss, grads, fa.launch_counts(),
                      (ssd.launches, ssd.einsum_dispatches))
    assert abs(out["cuda"][0].item() - out["eager"][0].item()) <= \
        1e-5 * abs(out["eager"][0].item())
    for a, b in zip(out["cuda"][1], out["eager"][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert _relmax(a, b) <= 1e-4
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = {"ssm": 0, "audio": cfg.n_layers,
            "hybrid": tfm.stack_program(cfg)[0][1]}[cfg.family]
    assert out["cuda"][2] == {"flash_attention": 0,
                              "flash_attention_lse": 2 * attn,
                              "flash_attention_bwd_dq": attn,
                              "flash_attention_bwd_dkv": attn}
    assert out["cuda"][3] == (0, 2 * mamba)
    assert out["eager"][3] == (0, 0)
    if mamba:
        ssd.reset_launches()
        with torch.no_grad():
            tfm.forward_prefill(make_engine("cuda"), cfg, params,
                                tokens=batch["tokens"], collect_caches=False)
        assert (ssd.launches, ssd.einsum_dispatches) == (mamba, 0)


@pytest.mark.parametrize("remat", [True, False])
def test_cuda_ssd_form_follows_grad_mode_on_the_card(card, remat):
    """Under grad every `cuda` ssd dispatch takes the einsum form, the
    forward and (with remat, `use_reentrant=False`) its recompute alike,
    and launches no SSD kernel; without grad, and under inference_mode,
    every dispatch launches the kernel."""
    cfg, params, batch = _family_small(card, "mamba2")
    eng = make_engine("cuda")
    leaves = {k: p.detach().clone().requires_grad_()
              for k, p in flatten(params).items()}
    ssd.reset_launches()
    loss = tfm.loss_fn(eng, cfg, unflatten_like(leaves, params), batch,
                       remat=remat, ce_chunk=16)
    assert (ssd.launches, ssd.einsum_dispatches) == (0, cfg.n_layers)
    torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert (ssd.launches, ssd.einsum_dispatches) == (
        0, (2 if remat else 1) * cfg.n_layers)
    for ctx in (torch.no_grad, torch.inference_mode):
        ssd.reset_launches()
        with ctx():
            tfm.loss_fn(eng, cfg, params, batch, remat=remat, ce_chunk=16)
        assert (ssd.launches, ssd.einsum_dispatches) == (cfg.n_layers, 0)


# ------------------------------------------------------ measured autotuner ---

@pytest.fixture
def tuned(card, tmp_path, monkeypatch):
    """A fresh persisted table in a scratch dir and an empty plan cache;
    the cache and the policy restored afterwards."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    backends.clear_tile_cache()
    autotune.reset()
    prev = backends.get_autotune_policy()
    yield card
    backends.set_autotune_policy(prev)
    backends.clear_tile_cache()
    autotune.reset()


def _under(policy, fn):
    """fn() under `policy` with an empty plan cache; its outputs and the
    keys it resolved with their sources."""
    backends.clear_tile_cache()
    with backends.autotune_policy(policy):
        out = fn()
    torch.cuda.synchronize()
    return out, {k: r["source"] for k, r in backends.autotune_report().items()}


def _gemm_case(card, grad):
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(1024, 896, generator=g, device=card)
    w = torch.randn(896, 4864, generator=g, device=card) / 30
    shift = torch.randn(4864, generator=g, device=card)

    def run():
        xs, ws = x.clone().requires_grad_(grad), w.clone().requires_grad_(grad)
        y = ops.matmul(xs, ws, None, shift, act="leaky")
        if not grad:
            return (y,)
        y.square().sum().backward()
        return y, xs.grad, ws.grad
    return run


def _bmm_case(card, grad):
    g = torch.Generator(device=card).manual_seed(6)
    shape = ((8, 64, 512), (8, 512, 256)) if grad else \
        ((64, 16, 2048), (64, 2048, 1408))   # deepseek's expert GEMM
    x = torch.randn(*shape[0], generator=g, device=card)
    w = torch.randn(*shape[1], generator=g, device=card) / 30

    def run():
        xs, ws = x.clone().requires_grad_(grad), w.clone().requires_grad_(grad)
        y = ops.bmm(xs, ws)
        if not grad:
            return (y,)
        y.square().sum().backward()
        return y, xs.grad, ws.grad
    return run


def _attn_case(card, grad):
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(2, 512, 14, 64, generator=g, device=card)
    k = torch.randn(2, 512, 2, 64, generator=g, device=card)
    v = torch.randn(2, 512, 2, 64, generator=g, device=card)

    def run():
        qs = q.clone().requires_grad_(grad)
        o = ops.attention(qs, k, v, causal=True)
        if not grad:
            return (o,)
        o.square().sum().backward()
        return o, qs.grad
    return run


@pytest.mark.parametrize("case,grad,ops_measured", [
    (_gemm_case, False, {"matmul"}),
    (_gemm_case, True, {"matmul", "gemm_bwd"}),
    (_bmm_case, False, {"bmm"}),
    (_bmm_case, True, {"bmm", "gemm_bwd"}),
    (_attn_case, False, {"attention"}),
    (_attn_case, True, {"attention", "attention_bwd"}),
])
def test_measured_pick_gives_the_heuristic_bits(tuned, case, grad,
                                                ops_measured):
    run = case(tuned, grad)
    want, heur = _under("heuristic", run)
    got, meas = _under("measure", run)
    assert set(heur) == set(meas)
    assert all(s == "heuristic" for s in heur.values())
    assert {json.loads(k)[0] for k, s in meas.items()
            if s == "measured"} == ops_measured
    if grad and case is not _attn_case:     # dx / dw, or bdx / bdw
        variants = {json.loads(k)[1][0] for k in meas
                    if k.startswith('["gemm_bwd"')}
        assert variants == ({"bdx", "bdw"} if case is _bmm_case
                            else {"dx", "dw"})
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_time_thunk_times_a_microsecond_kernel_on_the_device(tuned):
    x = torch.zeros(8, 64, device=tuned)
    w = torch.zeros(64, 64, device=tuned)
    ms = autotune.time_thunk(lambda: gemm.gemm_fused_fwd(
        x, w, plan=gemm.PLANS[0]))
    assert 0 < ms < 0.05, ms               # a launch alone takes longer


def test_fresh_process_resolution_times_nothing(tuned, monkeypatch):
    with backends.autotune_policy("measure"):
        plan = backends.get_backend("cuda").tiles("bmm", (64, 16, 2048, 1408),
                                                   torch.float32)
        assert backends.cache_stats()["measured"] == 1
        backends.clear_tile_cache()
        autotune.reset()

        def no_timing(*a, **kw):
            raise AssertionError("re-timed a persisted pick")
        monkeypatch.setattr(autotune, "time_thunk", no_timing)
        again = backends.get_backend("cuda").tiles(
            "bmm", (64, 16, 2048, 1408), torch.float32)
    st = backends.cache_stats()
    assert (st["measured"], st["persisted"]) == (0, 1)
    assert tuple(again) == tuple(plan)
