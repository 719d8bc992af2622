"""Process start (the top of ``run.py``, before ``torch`` is imported) to
the window's start, by the host's clock: imports, the CUDA context, the
kernels' build (the first run in a checkout), the program at the cell's
size, the pool of bits and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
