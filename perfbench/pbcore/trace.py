"""The device trace of a run's window: ``torch.profiler`` with CUDA
activity only (CUPTI: kernels, copies and the CUDA runtime and driver
calls that launch them) over the calls made in the first seconds of the
window.  Host operators are not recorded: recording them slows the host
by several microseconds an operator, which would inflate the idle share
the trace is there to read.

:func:`summarize` reduces the trace to what the per-layer readers take:
the traced window (the first event's start to the last one's end),
the union of the device's busy intervals in it, kernel launches and
device-to-host copies counted, device time by kernel, the idle gaps
labelled by the runtime call the host was in, or had last made, and the
device's events themselves (``(start_ns, end_ns, name)``)."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch


def profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def warm(cuda: bool, device) -> None:
    """Trace one small operation, so that the tracer's own start-up
    (CUPTI) is paid in set-up and not in the window."""
    prof = profiler(cuda)
    with prof:
        x = torch.ones(1024, device=device)
        (x * 2).sum().item()


def _raw(prof):
    """``(name, is_device, start_ns, end_ns)`` of every event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        # a span of record_function is mirrored on the device as a user
        # annotation: a label, not device work
        ann = getattr(e, "is_user_annotation", lambda: False)()
        out.append((e.name(), e.device_type() == cuda and not ann, s, s + d))
    return out


def summarize(prof, n_calls: int, top: int = 10) -> dict:
    ev = _raw(prof)
    host = sorted((s, t, name) for name, dev, s, t in ev if not dev)
    dev_ev = sorted((s, t, name) for name, dev, s, t in ev if dev)
    if not host and not dev_ev:
        return None
    w0 = min(e[0] for e in host + dev_ev)
    w1 = max(e[1] for e in host + dev_ev)
    kernels = sum(1 for e in dev_ev if not e[2].startswith(("Memcpy",
                                                             "Memset")))
    dtoh = sum(1 for e in dev_ev if e[2].startswith("Memcpy DtoH"))
    by_name = defaultdict(float)
    gaps, end = [], w0
    for s, t, name in dev_ev:
        by_name[name[:100]] += (t - s) / 1e9
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))

    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        if i < 0:
            label = "before the first runtime call"
        elif host[i][1] >= (a + b) / 2:
            label = host[i][2]
        else:
            label = "after " + host[i][2]
        idle[label[:100]] += (b - a) / 1e9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return dict(window_s=(w1 - w0) / 1e9,
                busy_s=union_s([(s, t) for s, t, _ in dev_ev]),
                n_calls=n_calls, kernels=kernels, dtoh=dtoh,
                device_ops=ranked(by_name), idle_gaps=ranked(idle),
                events=dev_ev)


def union_s(intervals) -> float:
    """The seconds that the union of ``(start_ns, end_ns)`` intervals
    covers."""
    busy, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            busy, end = busy + t - s, t
        elif t > end:
            busy, end = busy + t - end, t
    return busy / 1e9
