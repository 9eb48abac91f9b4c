"""The SSD kernel's plans and its three-step split, and the decode
partials and merge, on the CPU.

`ssd.plan_for` picks the SSD kernel's plan (``csrc/ssd.cu``'s header)
from the shape: the heads a y block serves from its score tiles and the
heads a state block walks.  The plan it picks at the
path's shapes is pinned here; every plan gives every output the same bits,
which the card tests and chip_smoke.py check, and a CPU tensor runs the
plain version under any plan.  The kernel cuts the chunk recurrence into
three steps (each chunk's own state contribution, the carry in chunk
order, the outputs from the state entering each chunk); a plain PyTorch
version of that split gives `ssd_scan_plain`'s bits.  The split-KV decode
keeps `combine`, the plain merge of the partials, as it was.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd

torch.set_num_threads(1)

# mamba2-1.3b's mixer: 64 heads of 64, one group, N 128, chunk 256
MAMBA = dict(h=64, p=64, g=1, n=128, chunk=256)
# ssm_serve's prompts less their last token (chip_smoke.py)
SERVE_LENGTHS = (38, 16, 19, 9, 32, 43, 27, 16)
# chip_smoke.py's SSD_GRID: (batch, S, H, P, G, N, chunk)
SSD_GRID = ((1, 512, 4, 64, 1, 128, 256), (4, 300, 8, 32, 2, 16, 64),
            (1, 1000, 8, 64, 2, 128, 256), (4, 130, 4, 32, 1, 128, 64),
            (1, 256, 4, 32, 2, 16, 256))


def _mamba(b, s):
    m = MAMBA
    return (b, s, m["h"], m["p"], m["g"], m["n"], m["chunk"])


# shape -> the plan's index in ssd.PLANS: the faster plan at each shape
# as kernels/time_ssd.py timed them on an H100 (batch-1 prefills of 256,
# 512 and 1000 tokens take one head a block, 2048 eight; 1 x 1000 is the
# nearest to the rule's threshold, 128 y blocks of 8 heads against 132)
PLAN_OF = ([(_mamba(4, 1000), 0), (_mamba(4, 2048), 0)]
           + [(_mamba(1, s), 1) for s in (256, 512, 1000)]
           + [(_mamba(1, 2048), 0)]
           + [(_mamba(1, s), 1) for s in sorted(set(SERVE_LENGTHS))]
           + [(case, 1) for case in SSD_GRID])


@pytest.mark.parametrize("shape,plan", PLAN_OF)
def test_plan_for_picks_the_pinned_plan(shape, plan):
    assert ssd.plan_for(*shape) == ssd.PLANS[plan]


def test_plans_are_the_instantiated_ones():
    assert len(set(ssd.PLANS)) == len(ssd.PLANS)
    for plan in ssd.PLANS:
        assert plan.y_heads >= 1 and plan.s_heads >= 1


def _inputs(b, s, h, p, g, n, seed, init=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h), np.float32)) - 0.5)
    a = -torch.exp(0.3 * torch.from_numpy(rng.standard_normal(h, np.float32)))
    bm = torch.from_numpy(rng.standard_normal((b, s, g, n), np.float32))
    cm = torch.from_numpy(rng.standard_normal((b, s, g, n), np.float32))
    st = (torch.from_numpy(rng.standard_normal((b, h, p, n), np.float32))
          if init else None)
    return x, dt, (dt * a).contiguous(), bm, cm, st


def test_an_uninstantiated_plan_is_refused_on_the_cpu():
    x, dt, da, bm, cm, _ = _inputs(1, 8, 4, 8, 1, 16, seed=0)
    with pytest.raises(ValueError, match="plan must be one of"):
        ssd.ssd_scan(x, dt, da, bm, cm, chunk=4, plan=(3, 3, 3))
    with pytest.raises(ValueError, match="plan must be one of"):
        ssd.ssd_scan(x, dt, da, bm, cm, chunk=4, plan=(16, 4))


@pytest.mark.parametrize("plan", ssd.PLANS)
def test_every_plan_runs_the_plain_version_on_the_cpu(plan):
    x, dt, da, bm, cm, st = _inputs(2, 21, 4, 8, 2, 16, seed=1, init=True)
    before = ssd.launches
    got = ssd.ssd_scan(x, dt, da, bm, cm, chunk=8, init_state=st, plan=plan)
    want = ssd.ssd_scan_plain(x, dt, da, bm, cm, chunk=8, init_state=st)
    assert ssd.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _three_step(x, dt, dA, B, C, *, chunk, init_state=None):
    """The kernel's split in plain PyTorch, with ssd_scan_plain's
    arithmetic for each piece: (1) each chunk's own contribution nw_c and
    exp(cs_last), chunk by chunk and independently; (2) the carry
    state_c = exp(cs_last) state_{c-1} + nw_c in chunk order, keeping the
    state entering each chunk; (3) each chunk's outputs from its own rows
    and the state entering it."""
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    starts = list(range(0, s, chunk))

    def rows(c0):
        c1 = min(c0 + chunk, s)
        xbar = x[:, c0:c1].float() * dt[:, c0:c1, :, None]
        cs = torch.cumsum(dA[:, c0:c1], dim=1)
        return c1 - c0, xbar, cs, B[:, c0:c1].float(), C[:, c0:c1].float()

    nws, decs = [], []
    for c0 in starts:                                   # step 1
        q, xbar, cs, bc, _ = rows(c0)
        decay_in = torch.exp(cs[:, -1:] - cs)
        new = torch.einsum("bkgrp,bkgn->bgrpn",
                           (xbar * decay_in[..., None]).reshape(
                               bt, q, g, rep, p), bc)
        nws.append(new.reshape(bt, h, p, n))
        decs.append(torch.exp(cs[:, -1])[..., None, None])
    state = (torch.zeros((bt, h, p, n), dtype=torch.float32)
             if init_state is None else init_state.float())
    entering = []
    for nw, dec in zip(nws, decs):                      # step 2
        entering.append(state)
        state = dec * state + nw
    ys = []
    for c0, st in zip(starts, entering):                # step 3
        q, xbar, cs, bc, cc = rows(c0)
        causal = torch.ones(q, q, dtype=torch.bool).tril()
        diff = cs[:, :, None, :] - cs[:, None, :, :]
        seg = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
        seg = seg.permute(0, 3, 1, 2).reshape(bt, g, rep, q, q)
        scores = torch.einsum("bqgn,bkgn->bgqk", cc, bc)
        y = torch.einsum("bgrqk,bkgrp->bqgrp", scores[:, :, None] * seg,
                         xbar.reshape(bt, q, g, rep, p))
        y_off = torch.einsum("bqgn,bgrpn->bqgrp", cc,
                             st.reshape(bt, g, rep, p, n))
        y = y + torch.exp(cs).reshape(bt, q, g, rep, 1) * y_off
        ys.append(y.reshape(bt, q, h, p))
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 37, 4, 8, 1, 16, 8), (1, 50, 4, 8, 2, 16, 16), (2, 16, 2, 4, 1, 8, 16),
    (1, 7, 4, 8, 1, 16, 256), (3, 65, 4, 4, 2, 8, 32)])
@pytest.mark.parametrize("init", [False, True])
def test_the_three_step_split_gives_the_plain_bits(b, s, h, p, g, n, chunk,
                                                    init):
    x, dt, da, bm, cm, st = _inputs(b, s, h, p, g, n, seed=s + n, init=init)
    want = ssd.ssd_scan_plain(x, dt, da, bm, cm, chunk=chunk, init_state=st)
    got = _three_step(x, dt, da, bm, cm, chunk=chunk, init_state=st)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_combine_keeps_its_arithmetic():
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.standard_normal((2, 3, 5, 2, 8), np.float32))
    lse = torch.from_numpy(3 * rng.standard_normal((2, 3, 5, 2), np.float32))
    lse[0, 1, 2:] = fd.EMPTY_SPAN_LSE
    o[0, 1, 2:] = 0.0
    lse[1, 2, :, 0] = fd.EMPTY_SPAN_LSE                 # a row with no key
    o[1, 2, :, 0] = 0.0
    m = lse.amax(2, keepdim=True)
    alpha = torch.exp(lse - m)
    want = (o * alpha[..., None]).sum(2) / alpha.sum(2)[..., None]
    got = fd.combine(o, lse)
    assert torch.equal(got, want)
    assert bool((got[1, 2, 0] == 0).all())


@pytest.mark.parametrize("causal", [True, False])
def test_decode_partials_on_the_cpu_are_the_plain_version(causal):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 3, 14, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 300, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 300, 2, 32), np.float32))
    kvl = torch.tensor([300, 77], dtype=torch.int32)
    before = fd.launches
    got = fd.flash_decode_partials(q, k, v, kvl, causal=causal, n_splits=3,
                                   span=128)
    want = fd.flash_decode_plain(q, k, v, kvl, causal=causal, n_splits=3,
                                 span=128)
    assert fd.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
