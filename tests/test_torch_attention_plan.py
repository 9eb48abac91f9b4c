"""The attention backward kernels' plans, on the CPU.

`flash_attention.bwd_plan_for` picks the dQ kernel's plan, its query rows
per block, from the shape (``csrc/flash_attention_bwd.cu``'s header).
The plan it picks at each shape below is the faster one as
``kernels/time_attention.py --bwd`` timed them on an H100, and its grid
must fit the launch limits.  Every plan gives every output the same bits,
which the card tests and chip_smoke.py check; here a CPU tensor runs the
plain version under any plan, with no launch.  The same holds for the
forward's plans; the split-KV decode with its merge (`flash_decode.
flash_decode`) runs the plain partials and `combine` on the CPU.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

torch.set_num_threads(1)

GRID_X = 2 ** 31 - 1  # the largest x extent of a 1-D grid

# (b, sq, h, kv) -> dQ rows per block.  qwen2-0.5b's training shape (head
# dim 64 and 128 alike), the long sequence, the lm_train_restart step
# (reduced qwen2-0.5b, 4 / 2 heads), chip_smoke.py's check_attn_bwd grid
# (batch 2, head ratios (16, 16), (14, 2), (8, 1), Sq 64 / 100 / 40), and
# causal sequences whose 64-row grids have 56 to 448 blocks.
PLAN_OF = (
    [((8, 512, 14, 2), 64), ((2, 2048, 14, 2), 64), ((2, 64, 4, 2), 16)]
    + [((2, sq, h, kv), 16) for h, kv in ((16, 16), (14, 2), (8, 1))
       for sq in (64, 100, 40)]
    + [((1, 256, 14, 2), 16), ((1, 320, 14, 2), 16), ((1, 512, 14, 2), 16),
       ((1, 640, 14, 2), 64), ((2, 512, 14, 2), 64), ((4, 512, 14, 2), 64)])


def _blocks(rows, b, sq, h, kv):
    """dQ blocks of a launch with `rows` query rows a block, as the C
    launcher computes them."""
    return -(-(h // kv) * sq // rows) * b * kv


@pytest.mark.parametrize("shape,rows", PLAN_OF)
def test_backward_plan_of_the_path_shapes(shape, rows):
    plan = fa.bwd_plan_for(*shape)
    assert plan == fa.BwdPlan(rows)
    assert plan in fa.BWD_PLANS and isinstance(plan, fa.BwdPlan)
    assert 1 <= _blocks(plan.rows, *shape) <= GRID_X


def test_backward_plan_of_the_training_shape_fills_the_card():
    plan = fa.bwd_plan_for(8, 512, 14, 2)
    assert plan == fa.BwdPlan(64)
    assert _blocks(plan.rows, 8, 512, 14, 2) >= fa.SMS


def _operands(seed, b, sq, skv, h, kv, d, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(dtype) for s in ((b, sq, h, d), (b, skv, kv, d),
                                        (b, skv, kv, d), (b, sq, h, d)))
    return q / 4, k, v, do


@pytest.mark.parametrize("plan", fa.BWD_PLANS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_backward_plan_runs_the_plain_version_on_the_cpu(plan, dtype):
    q, k, v, do = _operands(5, 2, 12, 20, 4, 2, 32, dtype)
    kvl = torch.tensor([20, 9], dtype=torch.int32)
    o, lse = fa.flash_attention_plain(q, k, v, kvl, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, kvl)
    before = fa.launch_counts()
    for p in (plan, tuple(plan)):
        assert torch.equal(fa.flash_attention_bwd_dq(*bwd, plan=p),
                           fa.flash_attention_bwd_dq_plain(*bwd))
    assert fa.launch_counts() == before


@pytest.mark.parametrize("plan", [(32,), (128,), (64, True), (16, 16),
                                  ("rows",)])
def test_a_backward_plan_that_is_not_instantiated_is_refused(plan):
    q, k, v, do = _operands(6, 1, 4, 4, 2, 1, 32, torch.float32)
    lse = delta = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="plan"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, plan=plan)


# The forward's plans.  (b, sq, h, kv) -> the plan `plan_for` picks:
# the 64-token serving chunk at batch 1 and 4, a 512-token prompt, the
# training shape (head dim 64 and 128 alike), the long sequence, the
# lm_train_restart step (reduced qwen2-0.5b, 4 / 2 heads), a decode row of
# the grid (the forward at Sq 1) and a sequence whose 128-row grid falls
# short of the SMs but whose 64-row grid does not.  The 512-token prompt's
# 112 64-row blocks cover half the SMs; the batch-4 chunk's 56 do not.
FWD_PLAN_OF = [((1, 64, 14, 2), fa.PLANS[2]), ((4, 64, 14, 2), fa.PLANS[2]),
               ((1, 512, 14, 2), fa.PLANS[0]), ((8, 512, 14, 2), fa.PLANS[1]),
               ((2, 2048, 14, 2), fa.PLANS[1]), ((2, 64, 4, 2), fa.PLANS[2]),
               ((2, 1, 16, 16), fa.PLANS[2]), ((1, 1024, 14, 2), fa.PLANS[0])]


def _fwd_blocks(plan, b, sq, h, kv):
    """Forward blocks of a launch under `plan`, as the C launcher computes
    them."""
    return -(-(h // kv) * sq // plan.rows) * b * kv


@pytest.mark.parametrize("shape,plan", FWD_PLAN_OF)
def test_forward_plan_of_the_path_shapes(shape, plan):
    got = fa.plan_for(*shape)
    assert got == plan
    assert got in fa.PLANS and isinstance(got, fa.FwdPlan)
    assert 1 <= _fwd_blocks(got, *shape) <= GRID_X


def test_forward_plans_split_rows_over_lanes():
    assert len(set(fa.PLANS)) == len(fa.PLANS)
    for plan in fa.PLANS:
        groups = plan.threads // plan.lanes  # rows held at once
        assert plan.lanes in (8, 16, 32) and plan.threads % 32 == 0
        assert plan.rows % groups == 0


@pytest.mark.parametrize("plan", fa.PLANS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_forward_plan_runs_the_plain_version_on_the_cpu(plan, dtype):
    q, k, v, _ = _operands(9, 2, 12, 20, 4, 2, 32, dtype)
    kvl = torch.tensor([20, 0], dtype=torch.int32)
    before = fa.launch_counts()
    for p in (plan, tuple(plan)):
        assert torch.equal(fa.flash_attention_fwd(q, k, v, kvl, plan=p),
                           fa.flash_attention_plain(q, k, v, kvl))
        o, lse = fa.flash_attention_fwd(q, k, v, kvl, return_lse=True,
                                        plan=p)
        want_o, want_lse = fa.flash_attention_plain(q, k, v, kvl,
                                                    return_lse=True)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert fa.launch_counts() == before


@pytest.mark.parametrize("plan", [(32, 128, 8), (64, 256, 16), (64, 256),
                                  (16, 128, 8), ("rows", 128, 8)])
def test_a_forward_plan_that_is_not_instantiated_is_refused(plan):
    q, k, v, _ = _operands(10, 1, 4, 4, 2, 1, 32, torch.float32)
    with pytest.raises(ValueError, match="plan"):
        fa.flash_attention_fwd(q, k, v, plan=plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_decode_with_its_merge_on_the_cpu_is_combine(dtype, causal):
    q, k, v, _ = _operands(11, 2, 3, 256, 14, 2, 32, dtype)
    kvl = torch.tensor([256, 70], dtype=torch.int32)
    before = fd.launches
    out, o_part, lse_part = fd.flash_decode(q, k, v, kvl, causal=causal,
                                            n_splits=4, span=64)
    assert fd.launches == before
    want = fd.flash_decode_plain(q, k, v, kvl, causal=causal, n_splits=4,
                                 span=64)
    assert torch.equal(o_part, want[0]) and torch.equal(lse_part, want[1])
    merged = fd.combine(*want).transpose(1, 2).to(dtype)
    assert out.shape == (2, 3, 14, 32) and out.dtype == dtype
    assert torch.equal(out, merged)
    assert torch.equal(fd.merge_plain(*want, dtype), merged)


def test_the_merge_keeps_combine_with_empty_spans():
    rng = np.random.default_rng(13)
    o = torch.from_numpy(rng.standard_normal((2, 4, 6, 3, 32), np.float32))
    lse = torch.from_numpy(3 * rng.standard_normal((2, 4, 6, 3), np.float32))
    lse[1, 2, 3:] = fd.EMPTY_SPAN_LSE
    o[1, 2, 3:] = 0.0
    lse[0, 1, :, 2] = fd.EMPTY_SPAN_LSE                 # a row with no key
    o[0, 1, :, 2] = 0.0
    got = fd.merge_plain(o, lse, torch.float32)
    assert torch.equal(got, fd.combine(o, lse).transpose(1, 2))
    assert bool((got[0, 2, 1] == 0).all())


def test_the_kernels_merge_limit_is_the_wrappers():
    """csrc/flash_decode.cu refuses to merge past the split count that
    `flash_decode.MERGE_MAX_SPLITS` names, the count held against
    `combine` on the card."""
    src = (Path(fd.__file__).parent / "csrc" / "flash_decode.cu").read_text()
    found = re.findall(r"constexpr int MERGE_MAX_SPLITS = (\d+);", src)
    assert found == [str(fd.MERGE_MAX_SPLITS)]


@pytest.mark.parametrize("skv,kv", [(3072, 1), (4096, 1), (4224, 2)])
def test_decode_around_the_merges_split_limit_on_the_cpu(skv, kv):
    """`ops.attention_decode` merges up to MERGE_MAX_SPLITS splits in the
    kernel's launch and past them with `merge_plain`; on the CPU both are
    the plain partials and `combine`, and agree with the plain attention."""
    ns, span = ops.decode_splits(skv, kv)
    assert (ns <= fd.MERGE_MAX_SPLITS) == (skv == 3072)
    q, k, v, _ = _operands(17, 2, 1, skv, 2 * kv, kv, 32, torch.float32)
    kvl = torch.tensor([skv, skv // 3], dtype=torch.int32)
    got = ops.attention_decode(q, k, v, kvl, causal=False)
    qs = ops.scale_queries(q)
    want = fd.merge_plain(*fd.flash_decode_plain(
        qs, k, v, kvl, causal=False, n_splits=ns, span=span), q.dtype)
    assert torch.equal(got, want)
    ref = fa.flash_attention_plain(qs, k, v, kvl, causal=False)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
