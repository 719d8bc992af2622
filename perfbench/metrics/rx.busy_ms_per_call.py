"""Device busy time of the operations launched inside the receiver's
spans (``rx.pd``, ``rx.eye``, ``rx.decide``, ``rx.readback``), per traced
call, in ms (:func:`perfbench.pbcore.spans.by_span`)."""
from perfbench.pbcore.spans import per_call


def read(ctx):
    return per_call(getattr(ctx, "span_cut", None), ("rx.",),
                    "busy_by_span", 1e3)
