"""The benchmark's FLOP arithmetic against the published totals."""
from __future__ import annotations

import math

import pytest

from harness import arith, spec
from reference import cfg

PUBLISHED = {"darknet19": (5.58e9, 20.8e6), "darknet53": (18.57e9, 41.6e6)}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_flops_and_params_match_published(name):
    conf = spec.load_config(name)
    table = cfg.layers(conf["cfg_text"])
    flops = arith.flops_per_image(table)
    assert flops == conf["flops_per_image"]
    assert round(flops / 1e7) / 100 == PUBLISHED[name][0] / 1e9
    params = sum(math.prod(s) for lay in cfg.weighted(table)
                 for s in cfg.param_shapes(lay).values())
    assert params == conf["params"]
    assert abs(params - PUBLISHED[name][1]) < 0.1e6


def test_layer_counts():
    d19 = cfg.layers(spec.load_config("darknet19")["cfg_text"])
    d53 = cfg.layers(spec.load_config("darknet53")["cfg_text"])
    kinds19 = [lay.type for lay in d19]
    kinds53 = [lay.type for lay in d53]
    assert kinds19.count("convolutional") == 19
    assert kinds19.count("maxpool") == 5
    assert kinds53.count("convolutional") == 52
    assert kinds53.count("shortcut") == 23
    assert kinds53[-2:] == ["connected", "softmax"]
    assert sum(lay.stride == 2 for lay in d53) == 5
    assert d19[-1].out_shape == d53[-1].out_shape == (1, 1, 1000)


def test_bound_takes_the_larger_term():
    lay = cfg.layers(spec.load_config("darknet19")["cfg_text"])[0]
    peak = {"fp32_flops": 1.0, "hbm_bytes": 1e30}
    assert arith.bound_s([lay], 2, peak) == arith.layer_work(lay, 2)[0]
    peak = {"fp32_flops": 1e30, "hbm_bytes": 1.0}
    assert arith.bound_s([lay], 2, peak) == arith.layer_work(lay, 2)[1]
