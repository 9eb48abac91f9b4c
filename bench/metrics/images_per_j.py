"""Images answered in the window over the joules the card drew in it
(NVML's energy counter, interpolated at the window's ends)."""


def read(run):
    if not run.energy_j:
        return None
    return run.completed / run.energy_j
