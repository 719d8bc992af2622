"""Device idle time while the host's innermost span was a ``fiber`` span
(the adaptive step's read-back and launch gaps), per traced call, in ms
(:func:`perfbench.pbcore.spans.by_span`)."""
from perfbench.pbcore.spans import per_call


def read(ctx):
    return per_call(getattr(ctx, "span_cut", None), ("fiber",),
                    "idle_by_span", 1e3)
