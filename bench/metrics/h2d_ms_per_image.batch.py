"""Device milliseconds per image of host-to-device copies (the step's
staging of the stacked images)."""


def read(run):
    if run.device is None or not run.completed:
        return None
    h2d = sum(s for name, s in run.device.copies.items() if "HtoD" in name)
    return 1e3 * h2d / run.completed
