"""Profiling hooks (port of ``opticomlib_tpu.utils.profiling``): a device
trace of a block through ``torch.profiler``, named regions in it, a wall
timer that synchronises the device at both ends, and the wall / busy / idle
bookkeeping of a profiled call.

The reference brackets every device with wall-clock ``tic``/``toc``
(reference utils.py:293-340), which this package keeps as
``execution_time``; on a card a call returns while its kernels still run,
so a time that means the device's work needs one of these.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# the JAX module's names; ``device_busy`` and ``profiled`` (the bookkeeping
# of scripts/profile_torch_paths.py) are importable by name
__all__ = ["trace", "annotate", "DeviceTimer"]


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block (host operators, and on a card
    every kernel and copy) into ``logdir`` as a Chrome trace,
    ``trace_<pid>_<ns>.json``: open it in Perfetto or ``chrome://tracing``.
    The device is synchronised before the trace is closed, so the kernels of
    the block are in it."""
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name the enclosed region in the trace
    (``torch.profiler.record_function``); costs a few microseconds outside
    a trace."""
    with torch.profiler.record_function(name):
        yield


class DeviceTimer:
    """Wall-clock timer with a device sync at both ends.  Use as a context
    manager::

        with DeviceTimer(x.device) as t:
            y = prog(x)
            t.sync(y)
        print(t.elapsed)

    ``device``: the device synchronised on entry and exit (``None``: the
    current CUDA device when there is a card, else nothing); :meth:`sync`
    waits for the device of the tensor it is given.
    """

    def __init__(self, device=None):
        self.elapsed: Optional[float] = None
        self._t0: Optional[float] = None
        self._device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self._device is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        elif self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    @staticmethod
    def sync(arr: torch.Tensor) -> None:
        """Wait for the work that produces ``arr``:
        ``torch.cuda.synchronize`` on its device (nothing for a CPU
        tensor, whose work is done when the call returns)."""
        if arr.device.type == "cuda":
            torch.cuda.synchronize(arr.device)

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self._t0
        return False


def device_busy(prof):
    """The device's share of a finished ``torch.profiler.profile``:
    ``(busy_us, n_ops, by_name)``, the union of the intervals of its CUDA
    kernels and copies in microseconds, their number, and ``{kernel name:
    (device microseconds, launches)}``."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    return busy, len(events), by_name


def profiled(label: str, fn, top: int = 12, out=print) -> dict:
    """Profile one ``fn()`` (ended by a synchronise) after one warm-up, and
    report through ``out`` its wall time, the device's busy time and idle
    share, and the device time of the ``top`` kernels by name.  Returns
    ``dict(wall_s, busy_s, idle, n_ops, by_name)``.  Needs a card."""
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=_activities()) as prof:
        with DeviceTimer() as t:
            fn()
    busy, n_ops, by_name = device_busy(prof)
    wall = t.elapsed
    out(f"{label}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle {1 - busy / 1e6 / wall:.1%}, "
        f"{n_ops} device operations")
    for name, (us, c) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        out(f"    {us / 1e3:9.3f} ms {c:6d} x  {name[:90]}")
    return dict(wall_s=wall, busy_s=busy / 1e6, idle=1 - busy / 1e6 / wall,
                n_ops=n_ops, by_name=by_name)
