"""The Darknet CNN train step (PyTorch port of
``repro/train/train_step.py::cnn_loss_fn`` / ``make_cnn_train_step``).

One forward and one backward of cross-entropy over a planned `Network`,
global-norm clipping and AdamW.  No backend-conditional gradient path: the
engine bound to the network dispatches its ops forward and backward alike;
on the `cuda` backend every GEMM of both runs through the hand-written
kernels (`kernels/gemm.py::GemmFused`).  The LM's `make_train_step` comes
with the LM slice.
"""
from __future__ import annotations

import torch

from repro_torch.train import optimizer as opt


def cnn_loss_fn(net, images: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """Mean cross-entropy of a planned Darknet classifier.

    The network ends in the cfg's own [softmax] layer, so the loss takes
    the log of probabilities clamped to [1e-30, 1] (early training can
    emit exact zeros).  labels: (B,) int64 class indices.
    """
    probs = net(images).float()
    logp = torch.log(torch.clamp(probs, 1e-30, 1.0))
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


def make_cnn_train_step(net, ocfg: opt.AdamWConfig):
    """Returns ``train_step(opt_state, (images, labels)) -> (opt_state,
    metrics)`` for a planned Darknet `Network`.

    The step updates the network's parameters in place (the JAX step
    returns new ones); `opt_state` starts as
    ``adamw_init(dict(net.named_parameters()))``.  metrics: ``{"loss",
    "grad_norm", "lr", "step"}``, loss and grad_norm as 0-d tensors on the
    network's device (reading them synchronises).
    """

    def train_step(opt_state, batch):
        images, labels = batch
        params = dict(net.named_parameters())
        loss = cnn_loss_fn(net, images, labels)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        grads, gnorm = opt.clip_by_global_norm(grads, ocfg.clip_norm)
        _, opt_state, lr = opt.adamw_update(ocfg, grads, opt_state, params)
        return opt_state, {"loss": loss.detach(), "grad_norm": gnorm,
                           "lr": lr, "step": opt_state["step"]}

    return train_step
