"""The program's spans joined to the device trace of the same run.

The program records spans on the host (``opticomlib_tpu_torch.utils
.profiling.span``: ``name``, ``id``, ``parent``, ``call``, ``t0_ns``,
``t1_ns`` on ``time.time_ns``, the clock of ``torch.profiler``'s events).
:func:`by_span` cuts the traced window of :mod:`perfbench.pbcore.trace`
into the innermost spans:

* each device operation goes to the innermost span open when its launch
  (the ``cudaLaunchKernel`` / ``cuLaunchKernel`` / ``cudaMemcpyAsync``
  call with the operation's correlation id) ran on the host, so that
  the lag between host and device does not move it; the device time it
  adds to the busy union (the part of it no earlier operation covered) is
  credited there, so the spans' busy times add up to the trace's
  ``busy_s``;
* each interval in which the device was idle is split across the innermost
  spans open on the host during it;
* only the spans of calls whose root span lies wholly inside the window in
  which the trace was on count; the rest of the time, and the operations
  launched outside those spans, go to ``outside`` (an operation whose
  launch is not in the trace to ``unlinked``).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

OUTSIDE = "outside"
UNLINKED = "unlinked"


def _events(prof):
    """``(name, is_device, start_ns, end_ns, correlation_id)`` of every
    event of the trace (as :func:`perfbench.pbcore.trace._raw`, with the
    correlation id that ties a device operation to its launch)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        ann = getattr(e, "is_user_annotation", lambda: False)()
        out.append((e.name(), e.device_type() == cuda and not ann, s, s + d,
                    e.correlation_id()))
    return out


def _innermost(spans):
    """The host's time line as disjoint ``(start, end, name)`` pieces, each
    named by the innermost span open over it (the nested spans of one
    thread)."""
    pieces, stack, t = [], [], None       # stack: (end, name) of open spans

    def close(upto):
        nonlocal t
        while stack and stack[-1][0] <= upto:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end
    for r in sorted(spans, key=lambda r: (r["t0_ns"], -r["t1_ns"])):
        a = r["t0_ns"]
        close(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][1]))
        t = a
        stack.append((r["t1_ns"], r["name"]))
    close(float("inf"))
    return pieces


def _split(a, b, pieces, starts, out):
    """Add the interval ``[a, b)`` to ``out`` by the pieces it overlaps,
    the rest to ``outside``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    covered = 0
    while i < len(pieces) and pieces[i][0] < b:
        lo, hi = max(pieces[i][0], a), min(pieces[i][1], b)
        if hi > lo:
            out[pieces[i][2]] += hi - lo
            covered += hi - lo
        i += 1
    if b - a > covered:
        out[OUTSIDE] += b - a - covered


def by_span(prof, spans: list, window) -> dict:
    """The trace of ``prof`` by span.  ``spans``: the records drained from
    the program; ``window``: ``(on_ns, off_ns)``, the host's
    ``time.time_ns()`` when the trace was started and stopped.  Returns
    ``None`` for an empty trace, else ``calls`` (the calls counted),
    ``busy_s``, ``idle_s`` (over the trace's own window, as
    :func:`~perfbench.pbcore.trace.summarize` takes it), and by span name,
    with ``outside`` and ``unlinked``: ``busy_by_span`` and
    ``idle_by_span`` (s), ``launches_by_span`` (kernels) and
    ``readbacks_by_span`` (device-to-host copies)."""
    ev = _events(prof)
    if not ev:
        return None
    dev = sorted((s, t, name, corr) for name, d, s, t, corr in ev if d)
    host = [(s, corr) for name, d, s, t, corr in ev if not d]
    w0 = min(e[2] for e in ev)
    w1 = max(e[3] for e in ev)
    on, off = window
    calls = {r["id"] for r in spans if r["parent"] is None
             and on <= r["t0_ns"] and r["t1_ns"] <= off}
    pieces = _innermost([r for r in spans if r["call"] in calls])
    starts = [p[0] for p in pieces]
    launched = {corr: s for s, corr in host if corr}

    def at(t):
        if t is None:
            return UNLINKED
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t < pieces[i][1] else OUTSIDE

    busy, idle = defaultdict(float), defaultdict(float)
    launches, readbacks = defaultdict(int), defaultdict(int)
    end = w0
    for s, t, name, corr in dev:
        label = at(launched.get(corr))
        if name.startswith("Memcpy DtoH"):
            readbacks[label] += 1
        elif not name.startswith(("Memcpy", "Memset")):
            launches[label] += 1
        s, t = max(s, w0), min(t, w1)
        if s > end:
            _split(end, s, pieces, starts, idle)
        if t > end:
            busy[label] += t - max(s, end)
            end = t
    if w1 > end:
        _split(end, w1, pieces, starts, idle)

    def seconds(d):
        return {k: v / 1e9 for k, v in sorted(d.items(), key=lambda kv:
                                                -kv[1])}
    return dict(calls=len(calls), busy_s=sum(busy.values()) / 1e9,
                idle_s=sum(idle.values()) / 1e9,
                busy_by_span=seconds(busy), idle_by_span=seconds(idle),
                launches_by_span=dict(launches),
                readbacks_by_span=dict(readbacks))


def per_call(cut, names, key: str, scale: float = 1.0):
    """The sum of ``cut[key]`` over the spans whose name is in ``names`` or
    starts with one ending in ``.``, per counted call, times ``scale``;
    ``None`` where nothing was cut or no call was counted."""
    if not cut or not cut["calls"]:
        return None
    tot = sum(v for k, v in cut[key].items()
              if k in names or any(n.endswith(".") and k.startswith(n)
                                   for n in names))
    return scale * tot / cut["calls"]
