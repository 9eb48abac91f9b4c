"""The convolution and connected layers' roofline share: the least time
the card could take for them over every dispatch of the window (per
layer the larger of FLOPs over the fp32 peak and bytes over HBM
bandwidth, `harness.arith`), over the device time of the kernels that
the kernel classes list for those layers, in percent."""
from harness import arith, spec

LAYERS = ("convolutional", "connected")


def read(run):
    if run.device is None or run.peak is None:
        return None
    names = [n for c in spec.kernel_classes(run.cell.root).values()
             if set(c["layers"]) & set(LAYERS) for n in c["names"]]
    busy = run.device.seconds_matching(names)
    if busy <= 0:
        return None
    bound = sum(n * arith.bound_s(run.table, b, run.peak)
                for b, n in run.dispatches.items())
    return 100.0 * bound / busy
