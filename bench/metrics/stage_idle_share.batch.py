"""Share of the traced window in which no kernel and no copy ran on the
card while the program's innermost span was a step's staging
(``serve.stage``: the batch taken from the queue, ``np.stack``,
``torch.as_tensor``) or the host side of its copy to the card
(``serve.h2d``), in percent (`harness.spans`)."""
from harness import spans


def read(run):
    trace = spans.of(run)
    if trace is None:
        return None
    return 100.0 * trace.stage_idle_s / trace.window_s
