"""Device-to-host copies launched inside the receiver's spans (``rx.*``:
the eye's and the decision's scalars read one by one, the RIN flag), per
traced call (:func:`perfbench.pbcore.spans.by_span`)."""
from perfbench.pbcore.spans import per_call


def read(ctx):
    return per_call(getattr(ctx, "span_cut", None), ("rx.",),
                    "readbacks_by_span")
