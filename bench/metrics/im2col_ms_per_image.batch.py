"""Device milliseconds per image of the kernels launched inside a
``repro.op.conv2d`` span that no kernel class lists, copies left out:
im2col's padding, slices and ``cat`` (`harness.spans`)."""
from harness import spans, spec

LAYERS = ("convolutional", "connected")


def read(run):
    trace = spans.of(run)
    if trace is None or not run.completed:
        return None
    names = [n for c in spec.kernel_classes(run.cell.root).values()
             if set(c["layers"]) & set(LAYERS) for n in c["names"]]
    glue = sum(s for (span, kernel), s in trace.device.items()
               if span == "repro.op.conv2d" and kernel not in trace.copies
               and not any(n in kernel for n in names))
    return 1e3 * glue / run.completed
