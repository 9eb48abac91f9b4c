"""The direct convolution's plans, on the CPU.

`conv_direct.plan_for` picks the kernel's tiling from the shape
(``csrc/conv_direct.cu``'s header).  The plan it picks at each DARKNET19
layer below is the one ``kernels/time_conv.py`` timed fastest (or within
3 % of it) on an H100, in fp32 and bf16.  Every plan gives every output
the same bits, which the card tests and chip_smoke.py check; here a CPU
tensor runs the plain version under any plan, with no launch, and that
plain version agrees with the JAX kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_direct import conv2d_direct as jax_conv2d_direct
from repro_torch.kernels import conv_direct as cd

torch.set_num_threads(1)

P = cd.PLANS
# The 11 DARKNET19 convolutions at batch 8 (layer, padded input
# (B, H, W, Cin), kernel size, Cout) -> the plan in fp32 and in bf16.
PLAN_OF = [
    (0, (8, 226, 226, 3), 3, 32, P[0], P[0]),
    (2, (8, 114, 114, 32), 3, 64, P[4], P[4]),
    (4, (8, 58, 58, 64), 3, 128, P[4], P[4]),
    (5, (8, 56, 56, 128), 1, 64, P[5], P[5]),
    (6, (8, 58, 58, 64), 3, 128, P[4], P[4]),
    (8, (8, 30, 30, 128), 3, 256, P[5], P[2]),
    (9, (8, 28, 28, 256), 1, 128, P[6], P[6]),
    (10, (8, 30, 30, 128), 3, 256, P[5], P[2]),
    (12, (8, 16, 16, 256), 3, 512, P[3], P[6]),
    (13, (8, 14, 14, 512), 1, 256, P[5], P[5]),
    (14, (8, 16, 16, 256), 3, 512, P[3], P[6]),
]


@pytest.mark.parametrize("layer,shape,k,cout,fp32,bf16", PLAN_OF)
def test_plan_of_the_darknet19_layers(layer, shape, k, cout, fp32, bf16):
    assert cd.plan_for(*shape, k, k, cout) == fp32
    assert cd.plan_for(*shape, k, k, cout, dtype=torch.float32) == fp32
    assert cd.plan_for(*shape, k, k, cout, dtype=torch.bfloat16) == bf16


@pytest.mark.parametrize("plan", P)
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape,k,cout", sorted({c[1:4] for c in PLAN_OF}))
def test_every_plan_fits_a_block_at_the_darknet19_layers(shape, k, cout,
                                                         plan, itemsize):
    oh, ow = shape[1] - k + 1, shape[2] - k + 1
    need = cd.smem_bytes(min(8, oh), k, k, plan=plan, oh=oh, ow=ow,
                         itemsize=itemsize)
    assert 0 < need <= cd.MAX_SMEM
    assert plan.kind in ("first", "band", "strip", "flat")
    assert plan.bm * plan.bn // (plan.tm * plan.tn) == plan.rg * plan.cg
    assert plan.rg * plan.cg in (64, 128, 256)


def test_the_plans_are_distinct_and_the_path_picks_them():
    assert len(set(P)) == len(P)
    picked = {cd.plan_for(*s, k, k, c, dtype=dt)
              for _, s, k, c, _, _ in PLAN_OF
              for dt in (torch.float32, torch.bfloat16)}
    assert picked <= set(P)


def _operands(seed, b, h, w, cin, k, cout, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    return x, wt, torch.from_numpy(x).to(dtype), torch.from_numpy(wt).to(dtype)


@pytest.mark.parametrize("plan", P)
@pytest.mark.parametrize("b,h,w,cin,k,cout", [
    (1, 9, 12, 3, 3, 8),     # the first layer's Cin
    (2, 6, 7, 5, 1, 12),     # 1 x 1, ragged Cin and Cout
    (1, 8, 9, 12, 3, 6)])    # more than one 8-channel group
def test_every_plan_runs_the_plain_version_on_the_cpu(plan, b, h, w, cin, k,
                                                      cout):
    x, wt, tx, tw = _operands(7, b, h, w, cin, k, cout, torch.float32)
    before = cd.launches
    for p in (plan, tuple(plan)):
        got = cd.conv2d_direct(tx, tw, plan=p)
        assert torch.equal(got, cd.conv2d_direct_plain(tx, tw))
    assert cd.launches == before
    want = np.asarray(jax_conv2d_direct(jnp.asarray(x), jnp.asarray(wt),
                                        interpret=True))
    err = np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-12)
    assert err <= 1e-5


@pytest.mark.parametrize("plan", [("first", 8, 8, 64, 4, 16),
                                  ("band", 8, 8, 16, 16, 8), ("wide",),
                                  (0,), "flat"])
def test_a_plan_that_is_not_instantiated_is_refused(plan):
    _, _, tx, tw = _operands(8, 1, 5, 5, 2, 3, 4, torch.float32)
    with pytest.raises(ValueError, match="plan"):
        cd.conv2d_direct(tx, tw, plan=plan)
