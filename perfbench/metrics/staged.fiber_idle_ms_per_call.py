"""Device idle time while a ``fiber`` span of the staged devices was open
(``FIBER``: the host's dispersion phase in ``fiber.prepare``, the
adaptive step's read-backs), per traced call, in ms
(:func:`perfbench.pbcore.staged.idle_ms_per_call`)."""
from perfbench.pbcore.staged import idle_ms_per_call


def read(ctx):
    return idle_ms_per_call(ctx, "fiber")
