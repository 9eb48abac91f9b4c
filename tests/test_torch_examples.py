"""The port's examples (`repro_torch/examples/`), each the twin of a
script of the JAX package's ``examples/``, run in this process on the CPU
(``--device cpu``; train_lm on the reduced qwen2-0.5b for two steps):
each takes its twin's steps and prints its twin's lines."""
import re

import pytest
import torch

from repro_torch.examples import (cnn_inference, quickstart, serve_cnn,
                                  serve_lm, train_lm)

torch.set_num_threads(1)


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("registered backends: (")
    assert re.fullmatch(r"engine backends agree: \S+", out[1])
    assert float(out[1].split()[-1]) <= 1e-4
    assert out[2].startswith("darknet CNN: input (4, 28, 28, 3) -> class "
                             "probs (4, 10), sum=1.0000, engine plan=")
    assert out[3].startswith("LM train loss (random init, V=")


def test_cnn_inference(capsys):
    cnn_inference.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    for line, name, shape in zip(out, ("darknet-small", "segnet-small",
                                       "darknet19"),
                                 ("(8, 28, 28, 3)", "(8, 32, 32, 3)",
                                  "(1, 224, 224, 3)")):
        assert line.startswith(f"[cnn] {name}")
        assert f"in={shape}" in line and "traces=1 plan=[" in line
    assert "out=(1, 1000)" in out[2] and "conv2dx11 matmulx1" in out[2]


def test_serve_cnn(capsys):
    serve_cnn.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve_cnn] served 33 requests in" in out
    assert "compiled=(1, 2, 4, 8) traces=4" in out
    assert "[serve_cnn] OK: one trace per bucket, all traffic served" in out


def test_serve_lm(capsys):
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve_lm] 8/8 requests, ")
    assert out[1].startswith("[serve_lm] latency p50=")
    assert out[2].startswith("[serve_lm] peak concurrency=")
    assert out[3] == "[serve_lm] sample generations (token ids):"
    assert len(out) == 8 and all(line.startswith("  req") for line in out[4:])


def test_train_lm(capsys, tmp_path):
    train_lm.main(["--device", "cpu", "--tiny", "--steps", "2", "--batch",
                   "2", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train_lm] params: ")
    assert [line.split()[1] for line in out[1:]] == ["step=0", "step=1"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]


def test_examples_default_to_the_card():
    """Like every entry point of the port they run on the card unless
    asked for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
