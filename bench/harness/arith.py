"""The benchmark's arithmetic: the work of each layer, whatever implements
it, and the peaks it is held against.

A convolution over B images does 2 * B * Ho * Wo * Cout * k * k * Cin
FLOPs; a [connected] layer 2 * B * Nin * Nout.  Its bytes are its input,
its weights, its epilogue vectors (BN's folded scale and shift, or a
bias) and its output, each moved once, in fp32.
"""
from __future__ import annotations

from reference.cfg import Layer, weighted

F32 = 4

# Published dense peaks of the card (NVIDIA's data sheet, SXM part, at the
# full 700 W): fp32 outside the tensor cores, and HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def layer_work(lay: Layer, batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one weighted layer over `batch` images."""
    h, w, cin = lay.in_shape
    ho, wo, cout = lay.out_shape
    if lay.type == "convolutional":
        flops = 2 * batch * ho * wo * cout * lay.size * lay.size * cin
        weights = lay.size * lay.size * cin * cout
    elif lay.type == "connected":
        flops = 2 * batch * h * w * cin * cout
        weights = h * w * cin * cout
    else:
        raise ValueError(f"{lay.type} holds no weights")
    vectors = 2 * cout if lay.batch_normalize else cout
    moved = batch * h * w * cin + weights + vectors + batch * ho * wo * cout
    return float(flops), float(F32 * moved)


def flops_per_image(table: list[Layer]) -> float:
    return sum(layer_work(lay, 1)[0] for lay in weighted(table))


def bound_s(table: list[Layer], batch: int, peak: dict) -> float:
    """The least time the card could take for the weighted layers of one
    dispatch of `batch` images: per layer the larger of FLOPs over the
    fp32 peak and bytes over the HBM bandwidth."""
    return sum(max(f / peak["fp32_flops"], b / peak["hbm_bytes"])
               for f, b in (layer_work(lay, batch)
                            for lay in weighted(table)))
