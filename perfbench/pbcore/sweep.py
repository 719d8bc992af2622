"""Device busy and idle time inside the one-card WDM sweep's channels,
from what ``run.py``'s traced run hands the per-layer readers: the spans
each traced call recorded (the ``sweep`` entry's first answer carries
them, ``spans``) and the device's events of the trace (``ctx.events``,
``(start_ns, end_ns, name)`` on ``time.time_ns``'s clock, the spans'
own).

The program opens a ``sweep.channel`` span around each channel's chain
(``LinkProgram._sweep``).  A span inside one (its ``tx``, ``fiber``,
``stage``, ``rx.pd``) is named ``sweep.channel/<name>`` here, so that the
innermost split of :mod:`perfbench.pbcore.spans` tells it from a span of
the same name elsewhere.  Each interval in which the device was busy (the
union of its events) and each one in which it was idle (between its
events, from the first span's start to the last one's end) is split
across the innermost spans open on the host during it."""
from __future__ import annotations

from collections import defaultdict

from perfbench.pbcore.spans import _innermost, _split

CHANNEL = "sweep.channel"


def _inside(recs: list) -> list:
    """``recs`` with the name of each span that lies inside a
    ``sweep.channel`` span prefixed ``sweep.channel/``."""
    by_id = {r["id"]: r for r in recs}

    def within(r):
        p = by_id.get(r["parent"])
        while p is not None:
            if p["name"] == CHANNEL:
                return True
            p = by_id.get(p["parent"])
        return False
    return [dict(r, name=f"{CHANNEL}/{r['name']}") if within(r) else r
            for r in recs]


def cut(ctx):
    """``(busy, idle, spans)``: the device's busy and idle ns by the
    innermost span open (named as above), and the traced calls' spans;
    ``None`` without a device trace, without traced calls, where a traced
    call carries no spans, or where no ``sweep.channel`` span was
    recorded (a program that opens none)."""
    if not getattr(ctx, "busy_s", None) or not ctx.calls:
        return None
    per_call = [res[0].get("spans") if res else None for res in ctx.calls]
    if any(not spans for spans in per_call):
        return None
    recs = [r for spans in per_call for r in spans]
    if not any(r["name"] == CHANNEL for r in recs):
        return None
    pieces = _innermost(_inside(recs))
    starts = [p[0] for p in pieces]
    busy, idle = defaultdict(int), defaultdict(int)
    end = pieces[0][0]
    for s, t in sorted((s, t) for s, t, _ in ctx.events):
        if s > end:
            _split(end, s, pieces, starts, idle)
        if t > end:
            _split(max(s, end), t, pieces, starts, busy)
            end = t
    if pieces[-1][1] > end:
        _split(end, pieces[-1][1], pieces, starts, idle)
    return busy, idle, recs


def fiber_busy_ms_per_step(ctx):
    """The device's busy time while a ``fiber`` span inside a
    ``sweep.channel`` span was the innermost open, over the split steps
    the traced calls' channels took (their answers' ``n_steps``), in ms;
    ``None`` where :func:`cut` finds nothing or no step was taken."""
    c = cut(ctx)
    steps = sum(sum(ch["n_steps"]) for res in ctx.calls for ch in res)
    if c is None or not steps:
        return None
    return c[0][f"{CHANNEL}/fiber"] / steps / 1e6


def idle_ms_per_channel(ctx):
    """The device's idle time while a ``sweep.channel`` span, or a span
    inside one, was the innermost open, per ``sweep.channel`` span of the
    traced calls, in ms; ``None`` where :func:`cut` finds nothing."""
    c = cut(ctx)
    if c is None:
        return None
    _, idle, recs = c
    n = sum(r["name"] == CHANNEL for r in recs)
    return sum(v for k, v in idle.items()
               if k == CHANNEL or k.startswith(CHANNEL + "/")) / n / 1e6
