"""Device idle time while an ``rx.*`` span of the staged devices was open
(``PD``'s mean read-back, the eager eye's host parts, the threshold scan,
the slicer's copy, the BER count), per traced call, in ms
(:func:`perfbench.pbcore.staged.idle_ms_per_call`)."""
from perfbench.pbcore.staged import idle_ms_per_call


def read(ctx):
    return idle_ms_per_call(ctx, "rx")
