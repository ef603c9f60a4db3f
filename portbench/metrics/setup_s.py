"""Seconds from the process's start (the first line of ``run.py``,
before torch is imported) to the window's start: imports, CUDA's
start, the phantom made and written, the kernels loaded or built and
one warm-up request at the cell's shape."""


def read(ctx):
    return ctx.setup_s
