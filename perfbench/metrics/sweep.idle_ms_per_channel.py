"""The device's idle time inside a ``sweep.channel`` span (the channel's
step read-backs and the host's work between its stages and before the
next channel), per channel of the traced sweeps, in ms
(:func:`perfbench.pbcore.sweep.idle_ms_per_channel`)."""
from perfbench.pbcore.sweep import idle_ms_per_channel


def read(ctx):
    return idle_ms_per_channel(ctx)
