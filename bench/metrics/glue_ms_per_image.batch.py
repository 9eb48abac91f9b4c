"""Device milliseconds per image of every kernel outside the classes of
the convolution and connected layers and outside copies: im2col, pools,
shortcut adds, softmax, padding (PyTorch operations)."""
from harness import spec

LAYERS = ("convolutional", "connected")


def read(run):
    if run.device is None or not run.completed:
        return None
    names = [n for c in spec.kernel_classes(run.cell.root).values()
             if set(c["layers"]) & set(LAYERS) for n in c["names"]]
    glue = run.device.kernel_s() - run.device.seconds_matching(names)
    return 1e3 * glue / run.completed
