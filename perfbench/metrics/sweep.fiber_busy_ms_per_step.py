"""The device's busy time while a ``fiber`` span inside a
``sweep.channel`` span was the innermost open, per split step the traced
sweeps' channels took, in ms: one adaptive step at the cell's size (two
FFTs and the fused passes;
:func:`perfbench.pbcore.sweep.fiber_busy_ms_per_step`)."""
from perfbench.pbcore.sweep import fiber_busy_ms_per_step


def read(ctx):
    return fiber_busy_ms_per_step(ctx)
