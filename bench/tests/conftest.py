"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
repository root (the repository's suite collects only ``tests/``).
CPU tests run at small sizes on the `eager` backend; tests marked
``cuda`` need the card and skip here."""
from __future__ import annotations

import re
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def shrink(cell, side: int = 32):
    """The cell at `side` x `side` images, with a small pool and buckets,
    for the CPU."""
    txt = cell.config["cfg_text"]
    txt = re.sub(r"height=\d+", f"height={side}", txt)
    cell.config["cfg_text"] = re.sub(r"width=\d+", f"width={side}", txt)
    prm = cell.params
    prm["pool"] = 8
    if prm["loop"] == "closed":
        prm.update(buckets=[4], backlog=8, warmup_steps=1)
    else:
        prm.update(buckets=[1, 2, 4], rate_per_s=40.0, warmup_s=0.1)
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
