"""Share of the traced window in which no kernel and no copy ran on the
card, in percent."""


def read(run):
    if run.device is None:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
