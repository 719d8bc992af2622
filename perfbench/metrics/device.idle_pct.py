"""The share of the traced window in which no kernel or copy ran on the
device, in %."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
