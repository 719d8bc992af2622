"""Device busy time of the operations launched inside the program's
``fiber`` spans (each fiber and DBP span of the link), per traced call, in
ms: each operation's part of the busy union, credited to the span its
launch ran in (:func:`perfbench.pbcore.spans.by_span`)."""
from perfbench.pbcore.spans import per_call


def read(ctx):
    return per_call(getattr(ctx, "span_cut", None), ("fiber",),
                    "busy_by_span", 1e3)
