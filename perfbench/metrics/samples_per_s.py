"""Waveform samples (``n_bits x sps x channels``; polarisations not
counted) of every call completed in the window, over the time from the
window's start to the end of its last call, by the host's clock."""


def read(ctx):
    return ctx.n_calls * ctx.samples_per_call / ctx.window_s
