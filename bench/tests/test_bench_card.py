"""On the card (marked ``cuda``; skipped on the CPU): the control comes
out as not correct, and a short run of a cell is correct."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import check, spec, traffic, weights
from reference import cfg, darknet

SEED = 2**31 + 4242


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["darknet19", "darknet53"])
def test_control_in_tf32_fails_the_check(name, card):
    conf = spec.load_config(name)
    table = cfg.layers(conf["cfg_text"])
    raw = weights.make(table, conf["weights"], SEED, card)
    images = torch.from_numpy(traffic.pool(SEED, 16, table[0].in_shape,
                                           card)).to(card)
    outs = []
    for tf32 in (False, True):
        with darknet.precision(tf32=tf32), torch.no_grad():
            outs.append(darknet.forward(table, raw, images).cpu().numpy())
    gap = check.log_gap(outs[1], outs[0]).max()
    assert gap > conf["limits"]["max_log_prob_gap"]
    assert np.isfinite(gap)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["darknet19.batch", "darknet53.stream"])
def test_short_run_on_the_card_is_correct(name, card):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m.name for m in
                                   spec.load_cell(name).end_to_end}
