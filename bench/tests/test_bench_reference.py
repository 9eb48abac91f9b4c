"""The plain reference against the program's `ref` backend on the CPU, on
both configurations at 32 x 32, from the same raw parameters."""
from __future__ import annotations

import pytest
import torch

from conftest import shrink
from harness import check, spec, traffic, weights
from reference import cfg, darknet
from repro_torch.core.darknet.network import Network
from repro_torch.core.engine import make_engine

CPU = torch.device("cpu")
# fp32 in both, summed in other orders through up to 52 layers: the CPU
# runs read 5e-7 (Darknet-19) and 7e-6 (Darknet-53).
TOL = 1e-4


def _program(text, raw, backend="ref"):
    net = Network(text, make_engine(backend, device=CPU))
    with torch.no_grad():
        for name, p in net.named_parameters():
            layer, key = name.split(".")
            p.copy_(raw[layer][key])
    return net


@pytest.mark.parametrize("name", ["darknet19.batch", "darknet53.batch"])
def test_reference_matches_the_ref_backend(name):
    cell = shrink(spec.load_cell(name))
    text = cell.config["cfg_text"]
    table = cfg.layers(text)
    raw = weights.make(table, cell.config["weights"], 2**31 + 5, CPU)
    images = traffic.pool(2**31 + 5, 4, table[0].in_shape, CPU)
    with torch.no_grad():
        want = darknet.forward(table, raw, torch.from_numpy(images))
        got = _program(text, raw)(torch.from_numpy(images))
    gap = check.log_gap(got.numpy(), want.numpy())
    assert gap.max() <= TOL
    # the outputs are spread: the softmax does not saturate
    assert float(want.max()) < 0.9 and float(want.min()) > 1e-12


def test_batch_norm_fold_is_not_trivial():
    cell = spec.load_cell("darknet53.batch")
    table = cfg.layers(cell.config["cfg_text"])
    raw = weights.make(table, cell.config["weights"], 3, CPU)
    bn = [p for p in raw.values() if "gamma" in p]
    assert len(bn) == 52
    for p in bn:
        scale = p["gamma"] / torch.sqrt(p["var"] + darknet.BN_EPS)
        assert (scale - 1).abs().max() > 1e-3
        assert p["beta"].abs().max() > 0 and p["mean"].abs().max() > 0


def test_reference_layer_types_cover_the_configs():
    kinds = set()
    for name in ("darknet19", "darknet53"):
        kinds |= {lay.type for lay in cfg.layers(
            spec.load_config(name)["cfg_text"])}
    assert kinds == {"convolutional", "maxpool", "avgpool", "shortcut",
                     "connected", "softmax"}


def test_gap_reads_logits_not_probabilities():
    p = torch.softmax(torch.tensor([[0.0, 1.0, 2.0]]), 1).numpy()
    q = torch.softmax(torch.tensor([[0.0, 1.0, 2.01]]), 1).numpy()
    gap = check.log_gap(q, p)[0]
    assert 0.005 < gap < 0.01
