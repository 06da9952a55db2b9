"""Seconds from the process's start to the window's start: imports, CUDA
initialisation, loading (or on a checkout's first run, building) the
program's kernels, the pool made on the card, and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
