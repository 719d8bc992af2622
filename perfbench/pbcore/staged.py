"""Device idle time inside the program's spans of the staged cell, from
what ``run.py``'s traced run hands the per-layer readers: the spans each
traced call recorded (the staged entry's answers carry them, ``spans``)
and the device's events of the trace (``ctx.events``, ``(start_ns,
end_ns, name)`` on ``time.time_ns``'s clock, the spans' own).

Each interval in which the device was idle (between its events, and
before the first and after the last as far as the spans reach) is split
across the innermost spans open on the host during it, as
:func:`perfbench.pbcore.spans.by_span` splits it; a layer's idle time is
that of its spans, ``layer`` and ``layer.<anything>``."""
from __future__ import annotations

from collections import defaultdict

from perfbench.pbcore.spans import _innermost, _split


def idle_ms_per_call(ctx, layer: str):
    """The device's idle time while a span named ``layer`` or
    ``layer.<anything>`` was the innermost open, per traced call, in ms;
    ``None`` without a device trace, without traced calls, or where a
    traced call carries no spans (a program that records none)."""
    if not getattr(ctx, "busy_s", None) or not ctx.calls:
        return None
    per_call = [res[0].get("spans") if res else None for res in ctx.calls]
    if any(not spans for spans in per_call):
        return None
    pieces = _innermost([r for spans in per_call for r in spans])
    starts = [p[0] for p in pieces]
    idle = defaultdict(int)
    end = pieces[0][0] if pieces else 0
    for s, t in sorted((s, t) for s, t, _ in ctx.events):
        if s > end:
            _split(end, s, pieces, starts, idle)
        end = max(end, t)
    if pieces and pieces[-1][1] > end:
        _split(end, pieces[-1][1], pieces, starts, idle)
    return sum(v for k, v in idle.items()
               if k == layer or k.startswith(layer + ".")) \
        / len(per_call) / 1e6
