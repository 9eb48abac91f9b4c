"""The plain reference of a Darknet classifier: PyTorch operations in
NCHW, one layer at a time, from the raw parameters the benchmark made.

It folds batch norm itself (gamma / sqrt(var + eps), beta - mean * scale),
applies leaky 0.1, and takes the [shortcut], pool and softmax sections as
Darknet defines them.  Precision is the caller's: `precision(tf32=False)`
holds fp32 products on the card; `tf32=True` is the control.  It imports
nothing of the program under test.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from reference.cfg import Layer

BN_EPS = 1e-5
LEAKY = 0.1


@contextlib.contextmanager
def precision(*, tf32: bool):
    """Run the block with TF32 on or off in matmuls and convolutions, and
    restore both flags after it."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "linear":
        return x
    if name == "leaky":
        return torch.where(x > 0, x, LEAKY * x)
    raise ValueError(f"activation {name!r} is not in the reference")


def _conv(lay: Layer, p: dict, x: torch.Tensor) -> torch.Tensor:
    cin = lay.in_shape[2]
    cout = lay.out_shape[2]
    w = p["w"].reshape(lay.size, lay.size, cin, cout).permute(3, 2, 0, 1)
    y = F.conv2d(x, w.contiguous(), stride=lay.stride, padding=lay.pad)
    if lay.batch_normalize:
        scale = p["gamma"] / torch.sqrt(p["var"] + BN_EPS)
        shift = p["beta"] - p["mean"] * scale
    else:
        scale, shift = None, p["b"]
    if scale is not None:
        y = y * scale[None, :, None, None]
    return _act(y + shift[None, :, None, None], lay.activation)


def forward(table: list[Layer], params: dict, images: torch.Tensor
            ) -> torch.Tensor:
    """images: (B, H, W, C) in [0, 1), NHWC as the requests carry them.
    Returns the (B, classes) softmax output.  `params` maps ``l{index}``
    to the layer's raw tensors (`cfg.param_shapes`)."""
    x = images.permute(0, 3, 1, 2)
    outs: list[torch.Tensor] = []
    for lay in table:
        if lay.type == "convolutional":
            x = _conv(lay, params[f"l{lay.index}"], x)
        elif lay.type == "maxpool":
            x = F.max_pool2d(x, lay.size, lay.stride)
        elif lay.type == "avgpool":
            x = x.mean(dim=(2, 3), keepdim=True)
        elif lay.type == "shortcut":
            x = _act(x + outs[lay.source], lay.activation)
        elif lay.type == "connected":
            p = params[f"l{lay.index}"]
            flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c)
            x = _act(flat @ p["w"] + p["b"], lay.activation)[:, :, None, None]
        elif lay.type == "softmax":
            x = torch.softmax(x.flatten(1), dim=1)[:, :, None, None]
        else:
            raise ValueError(f"layer type {lay.type!r} is not in the "
                             f"reference")
        outs.append(x)
    return x.flatten(1)


def forward_blocks(table: list[Layer], params: dict, images: torch.Tensor,
                   block: int) -> torch.Tensor:
    """`forward` over `images` in blocks of `block` rows, so a large set
    fits beside what is already on the card."""
    return torch.cat([forward(table, params, images[i:i + block])
                      for i in range(0, images.shape[0], block)])
