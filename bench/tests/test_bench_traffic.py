"""The seeded traffic: the same seed gives the same inputs, another seed
the same work in another order."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import seeds, traffic

CPU = torch.device("cpu")
BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, 2**40 + 3])
def test_same_seed_same_inputs(seed):
    a = traffic.pool(seed, 3, (8, 8, 3), CPU)
    b = traffic.pool(seed, 3, (8, 8, 3), CPU)
    assert np.array_equal(a, b)
    assert a.dtype == np.float32 and a.min() >= 0 and a.max() < 1
    assert np.array_equal(traffic.order(seed, 256), traffic.order(seed, 256))
    assert np.array_equal(traffic.arrival_offsets(seed, 300.0, 10.0),
                          traffic.arrival_offsets(seed, 300.0, 10.0))


def test_other_seed_same_work_other_order():
    a = traffic.arrival_offsets(1, 300.0, 10.0)
    b = traffic.arrival_offsets(2, 300.0, 10.0)
    assert len(a) == len(b) == 3000
    assert not np.array_equal(a, b)
    assert np.allclose(np.sort(np.diff(a, prepend=0)),
                       np.sort(np.diff(b, prepend=0)))
    assert abs(a[-1] - 10.0) < 0.1  # the gaps fill the window
    assert sorted(traffic.order(1, 256)) == list(range(256))


def test_streams_differ():
    assert len({seeds.derive(BIG, s) for s in seeds.STREAMS}) == 4
    assert seeds.derive(BIG, "weights") != seeds.derive(BIG + 1, "weights")
    with pytest.raises(ValueError):
        seeds.derive(-1, "weights")


def test_images_differ_in_statistics():
    imgs = traffic.pool(BIG, 16, (32, 32, 3), CPU)
    means = imgs.reshape(16, -1).mean(1)
    assert means.max() - means.min() > 0.05
