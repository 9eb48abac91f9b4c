"""The forward GEMM's plans (regime and tile) and the backward's, on the
CPU.

`ops.default_tiles` picks the forward's plan from (M, K, N): regime A up to
64 rows, regime B above (``csrc/gemm.cu``'s header).  Every plan it returns
must be instantiated and its grid must fit the launch limits.  Every plan
gives every output the same bits, which the card tests and chip_smoke.py
check; here a CPU tensor runs the plain version under any plan.  The
backward's split rule (`ops.default_bwd_tiles`) chooses the contraction
split and so the bits: it is pinned to the values it had before the
forward's plans existed.  The backward kernels' own plan
(`gemm.bwd_plan_for`, one of `gemm.BWD_PLANS`) is for speed only and never
feeds the split.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm, ops

torch.set_num_threads(1)

# The forward GEMMs of the paths, (M, K, N): DARKNET19_CFG at batch 1 and 8,
# qwen2-0.5b at M 1 / 8 / 64 / 4096 (q and o, k and v, gate and up, down,
# the tied head), mamba2-1.3b at M 1 / 4 / 1000 / 4000 (wz and wx, wB and
# wC, wdt, out, the tied head) and llama4-scout's expert GEMMs.
DARKNET19_B1 = [(50176, 27, 32), (12544, 288, 64), (3136, 576, 128),
                (3136, 128, 64), (784, 1152, 256), (784, 256, 128),
                (196, 2304, 512), (196, 512, 256), (1, 512, 1000)]
PATH_SHAPES = (
    DARKNET19_B1 + [(8 * m, k, n) for m, k, n in DARKNET19_B1[:-1]]
    + [(8, 512, 1000)]
    + [(m, k, n) for m in (1, 8, 64, 4096)
       for k, n in ((896, 896), (896, 128), (896, 4864), (4864, 896),
                    (896, 151936))]
    + [(m, k, n) for m in (1, 4, 1000, 4000)
       for k, n in ((2048, 4096), (2048, 128), (2048, 64), (4096, 2048),
                    (2048, 50288))]
    + [(256, 5120, 8192), (256, 8192, 5120), (2048, 4096, 16384)])
# (M, K, N, batch) -> the backward's (tile, splits) for dX, dW and the
# transposed-w dW (dE = dY^T . X), as they were before the forward's plans.
BWD_PLANS = [
    ((401408, 27, 32, 1), 32, 1, 32, 784, 32, 784),
    ((100352, 288, 64, 1), 64, 1, 32, 117, 32, 117),
    ((25088, 576, 128, 1), 64, 1, 32, 30, 32, 30),
    ((25088, 128, 64, 1), 64, 1, 32, 49, 32, 49),
    ((6272, 1152, 256, 1), 64, 1, 32, 8, 32, 8),
    ((6272, 256, 128, 1), 64, 1, 32, 12, 32, 12),
    ((1568, 2304, 512, 1), 64, 1, 64, 2, 64, 2),
    ((1568, 512, 256, 1), 32, 1, 32, 3, 32, 3),
    ((8, 512, 1000, 1), 32, 1, 32, 1, 32, 1),
    ((1, 896, 896, 1), 32, 1, 32, 1, 32, 1),
    ((1, 896, 128, 1), 32, 1, 32, 1, 32, 1),
    ((1, 896, 4864, 1), 32, 9, 64, 1, 64, 1),
    ((1, 4864, 896, 1), 32, 1, 64, 1, 64, 1),
    ((1, 896, 151936, 1), 32, 76, 64, 1, 64, 1),
    ((8, 896, 896, 1), 32, 1, 32, 1, 32, 1),
    ((8, 896, 128, 1), 32, 1, 32, 1, 32, 1),
    ((8, 896, 4864, 1), 32, 9, 64, 1, 64, 1),
    ((8, 4864, 896, 1), 32, 1, 64, 1, 64, 1),
    ((8, 896, 151936, 1), 32, 76, 64, 1, 64, 1),
    ((64, 896, 896, 1), 32, 1, 32, 1, 32, 1),
    ((64, 896, 128, 1), 32, 1, 32, 1, 32, 1),
    ((64, 896, 4864, 1), 32, 9, 64, 1, 64, 1),
    ((64, 4864, 896, 1), 32, 1, 64, 1, 64, 1),
    ((64, 896, 151936, 1), 32, 38, 64, 1, 64, 1),
    ((4096, 896, 896, 1), 64, 1, 32, 3, 32, 3),
    ((4096, 896, 128, 1), 64, 1, 32, 8, 32, 8),
    ((4096, 896, 4864, 1), 64, 1, 64, 1, 64, 1),
    ((4096, 4864, 896, 1), 64, 1, 64, 1, 64, 1),
    ((4096, 896, 151936, 1), 64, 1, 64, 1, 64, 1),
    ((1, 2048, 4096, 1), 32, 8, 64, 1, 64, 1),
    ((1, 2048, 128, 1), 32, 1, 32, 1, 32, 1),
    ((1, 2048, 64, 1), 32, 1, 32, 1, 32, 1),
    ((1, 4096, 2048, 1), 32, 4, 64, 1, 64, 1),
    ((1, 2048, 50288, 1), 32, 33, 64, 1, 64, 1),
    ((4, 2048, 4096, 1), 32, 8, 64, 1, 64, 1),
    ((4, 2048, 128, 1), 32, 1, 32, 1, 32, 1),
    ((4, 2048, 64, 1), 32, 1, 32, 1, 32, 1),
    ((4, 4096, 2048, 1), 32, 4, 64, 1, 64, 1),
    ((4, 2048, 50288, 1), 32, 33, 64, 1, 64, 1),
    ((1000, 2048, 4096, 1), 64, 2, 64, 1, 64, 1),
    ((1000, 2048, 128, 1), 64, 1, 32, 1, 32, 1),
    ((1000, 2048, 64, 1), 64, 1, 32, 1, 32, 1),
    ((1000, 4096, 2048, 1), 64, 1, 64, 1, 64, 1),
    ((1000, 2048, 50288, 1), 64, 2, 64, 1, 64, 1),
    ((4000, 2048, 4096, 1), 64, 1, 64, 1, 64, 1),
    ((4000, 2048, 128, 1), 64, 1, 32, 7, 32, 7),
    ((4000, 2048, 64, 1), 64, 1, 32, 7, 32, 7),
    ((4000, 4096, 2048, 1), 64, 1, 64, 1, 64, 1),
    ((4000, 2048, 50288, 1), 64, 1, 64, 1, 64, 1),
    ((256, 5120, 8192, 16), 64, 1, 64, 1, 64, 1),
    ((256, 8192, 5120, 16), 64, 1, 64, 1, 64, 1),
]


def _grid(plan, m, n, batch=1):
    return -(-m // plan.bm), -(-n // plan.bn), batch


def _check_plan(m, k, n, batch=1):
    plan = ops.default_tiles(m, k, n)
    assert plan in gemm.PLANS
    assert plan == gemm.plan_for(m, k, n) == ops.default_tiles(m, k, n)
    gx, gy, gz = _grid(plan, m, n, batch)
    assert gx < 2**31 and gy <= 65535 and gz <= gemm.MAX_GRID_Z
    # Regime A takes every shape (its ragged and unaligned pieces are
    # copied element by element), so every M up to 64 rows is A's.
    assert (plan.regime == "A") == (m <= gemm.A_MAX_ROWS)
    return plan


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_forward_plan_of_the_path_shapes(m, k, n):
    plan = _check_plan(m, k, n)
    if m <= 8:                       # decode rows: 8-row blocks
        assert plan == gemm.Plan("A", 8, 16)
    if m > 64 and k < 2048:          # short contractions: 64 x 32 tiles
        assert plan == gemm.Plan("B", 64, 32)


def test_forward_plan_over_a_seeded_grid():
    rng = np.random.default_rng(0)
    dims = np.concatenate([rng.integers(1, 130, (300, 3)),
                           np.exp(rng.uniform(0, 19, (300, 3))).astype(int)
                           + 1])
    for m, k, n in dims.tolist():
        _check_plan(m, k, min(n, 65535 * 16), batch=int(rng.integers(1, 9)))


@pytest.mark.parametrize("m,k,n,batch,dx_tile,dx_splits,dw_tile,dw_splits,"
                         "dwt_tile,dwt_splits",
                         [(*s, *p) for s, *p in BWD_PLANS])
def test_backward_plans_are_unchanged(m, k, n, batch, dx_tile, dx_splits,
                                      dw_tile, dw_splits, dwt_tile,
                                      dwt_splits):
    """dW's split sets its bits, so the backward keeps its own 64 / 32
    tile rule and the (tile, splits) it had."""
    bk = gemm.BK
    assert ops.default_bwd_tiles("dx", m, n, k, batch=batch) == (
        dx_tile, bk, dx_tile, dx_splits)
    assert ops.default_bwd_tiles("dw", k, m, n, batch=batch) == (
        dw_tile, bk, dw_tile, dw_splits)
    assert ops.default_bwd_tiles("dw", n, m, k, batch=batch) == (
        dwt_tile, bk, dwt_tile, dwt_splits)


@pytest.mark.parametrize("plan", gemm.PLANS)
def test_every_plan_runs_the_plain_version_on_the_cpu(plan):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((33, 177)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((177, 99)).astype(np.float32))
    shift = torch.from_numpy(rng.standard_normal(99).astype(np.float32))
    before = gemm.launch_counts()
    got = gemm.gemm_fused_fwd(x, w, None, shift, act="silu", plan=plan)
    assert torch.equal(got, gemm.gemm_fused_plain(x, w, None, shift,
                                                  act="silu"))
    xb, wb = x.reshape(3, 11, 177), w.expand(3, 177, 99)
    assert torch.equal(gemm.bmm_fwd(xb, wb, plan=tuple(plan)),
                       gemm.bmm_fwd_plain(xb, wb))
    assert gemm.launch_counts() == before


@pytest.mark.parametrize("plan", [("A", 32, 32), ("B", 64, 64), (64, 16, 64),
                                  ("C", 64, 64)])
def test_a_plan_that_is_not_instantiated_is_refused(plan):
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="plan"):
        gemm.gemm_fused_fwd(x, w, plan=plan)
    with pytest.raises(ValueError, match="plan"):
        gemm.bmm_fwd(x[None], w[None], plan=plan)
    with pytest.raises(ValueError, match="plan"):
        ops.matmul(x, w, tiles=plan)


def test_regime_counts_are_counted_and_reset():
    counts = gemm.launch_counts()
    assert {"gemm_fwd_regime_a", "gemm_fwd_regime_b"} <= set(counts)
    gemm.reset_launches()
    assert set(gemm.launch_counts().values()) == {0}


def _bwd_cases(m, k, n, batch=1):
    """The backward GEMMs of the forward (m, k, n) as (variant, rows,
    contraction, cols): dX, dW, and a tied head's dE = dY^T . X."""
    return [("dx", m, n, k), ("dw", k, m, n), ("dw", n, m, k)]


def _check_bwd_plan(variant, rows, kdim, cols, batch=1):
    plan, splits = ops.bwd_plan(variant, rows, kdim, cols, batch)
    assert plan in gemm.BWD_PLANS
    assert plan == gemm.bwd_plan_for(variant, rows, kdim, cols, batch)
    assert splits == ops.default_bwd_tiles(variant, rows, kdim, cols,
                                           batch)[3]
    chunk, launched = gemm.split_chunk(kdim, splits)
    assert launched == splits and chunk % gemm.BK == 0
    assert -(-cols // plan.bn) <= 65535
    assert batch * splits <= gemm.MAX_GRID_Z
    return plan


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_backward_plan_of_the_path_shapes(m, k, n):
    """Every backward plan of the paths is instantiated, fits the grid and
    is launched with the pinned split."""
    batch = 16 if (m, k, n) in ((256, 5120, 8192), (256, 8192, 5120)) else 1
    for case in _bwd_cases(m, k, n):
        _check_bwd_plan(*case, batch=batch)
    if m == 4096 and k * n >= 896 * 4864:  # the LM train step's big GEMMs
        assert gemm.bwd_plan_for("dx", m, n, k) == gemm.BwdPlan(128, 128)
        assert gemm.bwd_plan_for("dw", k, m, n) == gemm.BwdPlan(128, 128)


def test_backward_plan_over_a_seeded_grid():
    rng = np.random.default_rng(1)
    dims = np.concatenate([rng.integers(1, 130, (300, 3)),
                           np.exp(rng.uniform(0, 19, (300, 3))).astype(int)
                           + 1])
    for m, k, n in dims.tolist():
        batch = int(rng.integers(1, 9))
        for variant, rows, kdim, cols in _bwd_cases(m, k, n):
            _check_bwd_plan(variant, rows, kdim, min(cols, 65535 * 32),
                            batch)


@pytest.mark.parametrize("transposed", [False, True])
def test_backward_is_launched_with_the_pinned_split(monkeypatch, transposed):
    """`ops.matmul` and `ops.bmm` under grad hand the backward wrappers
    `bwd_plan_for`'s plan and `default_bwd_tiles`' split (dW of a
    transposed w as the swapped product dE = dY^T . X)."""
    calls = []
    for name in ("gemm_bwd_dx", "gemm_bwd_dw", "bmm_bwd_dx", "bmm_bwd_dw"):
        real = getattr(gemm, name)
        monkeypatch.setattr(gemm, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append((_n, kw["plan"], kw["splits"])) or _r(*a, **kw)))
    rng = np.random.default_rng(5)
    m, k, n = 2048, 40, 1536  # small outputs, long contractions: split
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, k) if transposed else (k, n))
                         .astype(np.float32))
    x.requires_grad_()
    w.requires_grad_()
    ops.matmul(x, w.t() if transposed else w).sum().backward()
    dw_case = ("dw", n, m, k) if transposed else ("dw", k, m, n)
    assert calls == [("gemm_bwd_dx", *ops.bwd_plan("dx", m, n, k)),
                     ("gemm_bwd_dw", *ops.bwd_plan(*dw_case))]
    assert calls[0][2] > 1 and calls[1][2] > 1
    calls.clear()
    xb = x.detach().reshape(4, 512, k).requires_grad_()
    wb = torch.stack([w.detach().t() if transposed else w.detach()] * 4)
    ops.bmm(xb, wb.requires_grad_()).sum().backward()
    assert calls == [("bmm_bwd_dx", *ops.bwd_plan("dx", 512, n, k, 4)),
                     ("bmm_bwd_dw", *ops.bwd_plan("dw", k, 512, n, 4))]


@pytest.mark.parametrize("plan", gemm.BWD_PLANS)
def test_every_backward_plan_runs_the_plain_version_on_the_cpu(plan):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((33, 177)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((177, 99)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((33, 99)).astype(np.float32))
    before = gemm.launch_counts()
    for splits in (1, 3):
        assert torch.equal(gemm.gemm_bwd_dx(dy, w, plan=plan, splits=splits),
                           gemm.gemm_bwd_dx_plain(dy, w))
        assert torch.equal(gemm.gemm_bwd_dx(dy, w.t().contiguous().t(),
                                            plan=tuple(plan), splits=splits),
                           gemm.gemm_bwd_dx_plain(dy, w))
        assert torch.equal(gemm.gemm_bwd_dw(x, dy, plan=plan, splits=splits),
                           gemm.gemm_bwd_dw_plain(x, dy))
        xb, dyb = x.reshape(3, 11, 177), dy.reshape(3, 11, 99)
        wb = w.expand(3, 177, 99)
        assert torch.equal(gemm.bmm_bwd_dx(dyb, wb, plan=plan,
                                           splits=splits),
                           gemm.bmm_bwd_dx_plain(dyb, wb))
        assert torch.equal(gemm.bmm_bwd_dw(xb, dyb, plan=plan,
                                           splits=splits),
                           gemm.bmm_bwd_dw_plain(xb, dyb))
    assert gemm.launch_counts() == before


@pytest.mark.parametrize("plan", [(64, 64), (32, 16), (128, 128, 8),
                                  ("B", 128, 128), (16, 16)])
def test_a_backward_plan_that_is_not_instantiated_is_refused(plan):
    x, dy, w = torch.zeros(6, 4), torch.zeros(6, 5), torch.zeros(4, 5)
    for fn, args in ((gemm.gemm_bwd_dx, (dy, w)), (gemm.gemm_bwd_dw, (x, dy)),
                     (gemm.bmm_bwd_dx, (dy[None], w[None])),
                     (gemm.bmm_bwd_dw, (x[None], dy[None]))):
        with pytest.raises(ValueError, match="plan"):
            fn(*args, plan=plan)
    with pytest.raises(ValueError, match="variant"):
        gemm.bwd_plan_for("dy", 4, 6, 5)


# llama4-scout's expert GEMMs (16 experts) at the MoE path's dispatch rows
# (B x capacity): the batched forward's plan measured fastest on an H100
# (`kernels/time_gemm.py --bmm`, PERF.md)
EXPERT_PLANS = [(8, gemm.Plan("A", 8, 16)), (16, gemm.Plan("B", 64, 32)),
                (32, gemm.Plan("B", 64, 32)), (64, gemm.Plan("B", 64, 32)),
                (80, gemm.Plan("B", 128, 128)),
                (160, gemm.Plan("B", 64, 32))]


@pytest.mark.parametrize("k,n", [(5120, 8192), (8192, 5120)])
@pytest.mark.parametrize("m,plan", EXPERT_PLANS)
def test_bmm_plan_of_the_expert_shapes(m, plan, k, n):
    assert ops.bmm_plan_for(m, k, n) == plan


def test_bmm_plan_is_the_engines_and_short_contractions_keep_theirs():
    """The engine's `bmm` dispatch and the `cuda` einsum (through
    `ops.bmm`) take `bmm_plan_for`; below a 2048-deep contraction it is
    the 2-D rule, `default_tiles`."""
    from repro_torch.core import backends
    for m, k, n in [(2, 32, 16), (17, 23, 9), (100, 70, 130),
                    (256, 1024, 4096)]:
        assert ops.bmm_plan_for(m, k, n) == ops.default_tiles(m, k, n)
    for m, k, n in [(32, 5120, 8192), (256, 5120, 8192), (80, 8192, 5120)]:
        assert backends.get_backend("cuda").tiles(
            "bmm", (m, k, n), torch.float32) == tuple(
                ops.bmm_plan_for(m, k, n))
    assert ops.bmm_plan_for(256, 5120, 8192) == ops.default_tiles(
        256, 5120, 8192)  # engine_bmm's shape keeps its plan
