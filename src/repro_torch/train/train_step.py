"""Training steps (PyTorch port of ``repro/train/train_step.py``).

`make_train_step` is the LM step: microbatched gradient accumulation in
fp32, optional error-feedback compression, global-norm clipping and AdamW
over the flat name -> tensor dict of the nested LM parameters
(`repro_torch.tree.flatten`: ``"layers.3.attn.wq"``).
`make_cnn_train_step` is the Darknet counterpart: cross-entropy over a
planned `Network`.  No backend-conditional gradient path: the engine
dispatches its ops forward and backward alike; on the `cuda` backend every
GEMM runs through `kernels/gemm.py::GemmFused` and every attention through
`kernels/flash_attention.py::FlashAttention`, hand-written kernels both
ways.  The JAX step returns new trees; these update the parameters and
moments in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import ef_compress_tree
from repro_torch.tree import flatten, unflatten_like


def make_train_step(engine, cfg, ocfg: opt.AdamWConfig, *,
                    num_microbatches: int = 1, remat: bool = True,
                    ce_chunk: int = 512, grad_compression: bool = False):
    """Returns ``train_step(params, opt_state, batch[, err])``.

    params: the nested LM parameters (`tfm.init_params`), updated in place
    and returned; opt_state: ``opt.adamw_init(flatten(params))``; batch:
    ``{"tokens", "labels"}``, (B, S) int tensors on the engine's device.
    The batch is cut into `num_microbatches` equal slices along B; their
    gradients are summed in fp32 and divided by the count, as their
    losses.  Returns ``(params, opt_state, metrics)``, or with
    ``grad_compression`` ``(params, opt_state, err, metrics)`` (err the
    flat error-feedback tree).  metrics: ``{"loss", "grad_norm", "lr",
    "step"}``, loss and grad_norm 0-d tensors on the device.  The JAX
    ``n_q_chunks`` and ``kernel_attention`` pick its blockwise attention
    oracle, which the port does not have (see `tfm.loss_fn`).
    """

    def loss(params, batch):
        return tfm.loss_fn(engine, cfg, params, batch, remat=remat,
                           ce_chunk=ce_chunk)

    def value_and_grad(params, batch):
        # Fresh leaves that share the parameters' storage, so the caller's
        # tensors are not marked as requiring grad.
        leaves = {k: p.detach().requires_grad_()
                  for k, p in flatten(params).items()}
        lval = loss(unflatten_like(leaves, params), batch)
        return lval.detach(), dict(zip(leaves, torch.autograd.grad(
            lval, list(leaves.values()))))

    def grads_of(params, batch):
        m = num_microbatches
        if m == 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} "
                             f"microbatches")
        per = b // m
        lsum, gsum = 0.0, None
        for i in range(m):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            lval, grads = value_and_grad(params, mb)
            lsum = lsum + lval
            if gsum is None:
                gsum = {k: g.float() for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    gsum[k] += g.float()
        return lsum / m, {k: g / m for k, g in gsum.items()}

    def train_step(params, opt_state, batch, err=None):
        lval, grads = grads_of(params, batch)
        if grad_compression:
            grads, err = ef_compress_tree(grads, err)
        grads, gnorm = opt.clip_by_global_norm(grads, ocfg.clip_norm)
        _, opt_state, lr = opt.adamw_update(ocfg, grads, opt_state,
                                            flatten(params))
        metrics = {"loss": lval, "grad_norm": gnorm, "lr": lr,
                   "step": opt_state["step"]}
        if grad_compression:
            return params, opt_state, err, metrics
        return params, opt_state, metrics

    return train_step


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
