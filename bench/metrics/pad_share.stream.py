"""Padded rows over all rows the `CompileCache` dispatched in the window
(its ``rows_padded`` and ``rows_real`` counters), in percent."""


def read(run):
    total = run.rows_real + run.rows_padded
    return 100.0 * run.rows_padded / total if total else None
