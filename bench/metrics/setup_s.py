"""Set-up: process start to the window's start (imports, CUDA context,
kernel libraries, weights, pool, bucket builds and warm-up traffic)."""


def read(run):
    return run.setup_s
