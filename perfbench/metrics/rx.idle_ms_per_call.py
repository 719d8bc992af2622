"""Device idle time while the host's innermost span was one of the
receiver's (``rx.*``), per traced call, in ms
(:func:`perfbench.pbcore.spans.by_span`)."""
from perfbench.pbcore.spans import per_call


def read(ctx):
    return per_call(getattr(ctx, "span_cut", None), ("rx.",),
                    "idle_by_span", 1e3)
