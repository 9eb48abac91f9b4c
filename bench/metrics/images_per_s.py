"""Images answered in the window over the window's seconds (the window
ends when its last step does)."""


def read(run):
    return run.completed / (run.t1 - run.t0)
