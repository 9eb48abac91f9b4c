"""The whole step's share of the card's fp32 peak: the configuration's
FLOPs per image times the images answered, over the window's seconds
times the peak (67 TFLOP/s outside the tensor cores: the program runs
fp32 with TF32 off), in percent."""
from harness import arith


def read(run):
    if run.peak is None:
        return None
    flops = arith.flops_per_image(run.table) * run.completed
    return 100.0 * flops / ((run.t1 - run.t0) * run.peak["fp32_flops"])
