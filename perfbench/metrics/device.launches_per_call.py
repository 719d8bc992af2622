"""Kernels that ran on the device (every launch: cuFFT's, Triton's, the
CUDA C++ kernels', PyTorch's) over the traced calls."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return ctx.kernels / ctx.n_calls
