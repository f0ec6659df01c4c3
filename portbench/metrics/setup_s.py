"""Seconds from the process's start to the window's: imports, the
kernels' build or its cache, the weights, the index filled, a batch of
each prompt length served to warm the shapes."""


def read(run):
    return run.setup_s
