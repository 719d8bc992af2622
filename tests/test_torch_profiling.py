"""The port's profiling hooks (opticomlib_tpu_torch.utils.profiling) on the
CPU: a Chrome trace of a block with its named region in it, the wall timer,
the busy-interval bookkeeping, and the span recorder; the public names are
the JAX module's."""
import glob
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from opticomlib_tpu.utils import profiling as jprofiling
from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_public_names():
    assert set(profiling.__all__) == set(jprofiling.__all__)
    assert callable(profiling.device_busy) and callable(profiling.profiled)


def test_trace_writes_a_chrome_trace_with_the_region(tmp_path):
    n = 4096
    A = torch.ones(n, dtype=torch.complex64) * 0.1
    w = 2 * np.pi * np.fft.fftfreq(n) * 160e9
    logdir = tmp_path / "trace" / "nested"      # made when missing
    with profiling.trace(str(logdir)):
        with profiling.annotate("ssfm"):
            out, steps = ssfm.ssfm_propagate(A, w, 2.0, beta_2=-20,
                                             gamma=1.3, h=0.5)
    assert steps == 4 and torch.isfinite(out.abs()).all()
    files = glob.glob(str(logdir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ssfm" in names
    assert any(str(nm).startswith("aten::") and "fft" in str(nm)
               for nm in names)
    # a second trace of the same directory is a second file
    with profiling.trace(str(logdir)):
        pass
    assert len(glob.glob(str(logdir / "trace_*.json"))) == 2


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("nothing"):
        x = torch.ones(3).sum()
    assert x == 3


def test_device_timer_brackets_the_block():
    with profiling.DeviceTimer("cpu") as t:
        time.sleep(0.05)
        y = torch.ones(8) * 2
        assert t.sync(y) is None
    assert 0.05 <= t.elapsed < 1.0
    with profiling.DeviceTimer() as t2:        # no card: nothing to wait for
        pass
    assert 0 <= t2.elapsed < 0.05


def _ev(name, a, b, cuda=True):
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(
        start=a, end=b, elapsed_us=lambda: b - a))


def test_device_busy_is_the_union_of_the_device_intervals():
    """Overlapping, nested, touching and disjoint intervals; host events do
    not count."""
    prof = SimpleNamespace(events=lambda: [
        _ev("k1", 0, 10), _ev("k2", 5, 12), _ev("k1", 6, 8),
        _ev("copy", 12, 13), _ev("k2", 20, 25), _ev("host", 0, 100, False)])
    busy, n_ops, by_name = profiling.device_busy(prof)
    assert busy == 13 + 5 and n_ops == 5
    assert by_name == {"k1": (12, 2), "k2": (12, 2), "copy": (1, 1)}
    assert profiling.device_busy(SimpleNamespace(events=lambda: [])) == (
        0.0, 0, {})


@pytest.fixture
def recording():
    """Span recording on for the test, off and drained after it."""
    profiling.record(True)
    profiling.drain()
    yield
    profiling.record(False)


#: The tracemalloc window of the test below, in a fresh interpreter: what
#: earlier tests left in a process (objects in reference cycles, a free
#: list emptied or filled, callbacks of other packages) could otherwise
#: allocate inside the window and be traced to a span's frame.
_SPANS_OFF_WINDOW = """
import gc, tracemalloc
from types import SimpleNamespace
from opticomlib_tpu_torch.utils import profiling

def clock():
    raise SystemExit("clock read")

profiling.record(False)
profiling.time = SimpleNamespace(time_ns=clock)
gc.collect()
gc.disable()
tracemalloc.start()
for _ in range(10_000):
    with profiling.span("a", kind="x") as s:
        s.set(steps=3)
held = tracemalloc.take_snapshot().filter_traces(
    [tracemalloc.Filter(True, profiling.__file__)])
tracemalloc.stop()
print(sum(st.size for st in held.statistics("filename")),
      len(profiling.drain()))
"""


def test_spans_off_record_nothing_and_read_no_clock():
    profiling.record(False)
    assert profiling.drain() == []
    sp = profiling.span("a", kind="x")
    assert sp is profiling.span("b")          # one shared object
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-c", _SPANS_OFF_WINDOW], cwd=root,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    held, recorded = map(int, run.stdout.split()[-2:])
    assert held == 0
    assert recorded == 0


def test_span_nesting_gives_parent_and_call(recording):
    with profiling.span("call.one", n=4) as root:
        with profiling.span("tx"):
            pass
        with profiling.span("fiber", kind="fiber") as f:
            with profiling.span("inner"):
                pass
            f.set(steps=7)
    with profiling.span("call.two"):
        with profiling.span("tx"):
            pass
    recs = profiling.drain()
    assert profiling.drain() == []
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
        assert set(r) == {"name", "id", "parent", "call", "t0_ns", "t1_ns",
                          "attrs"}
        assert r["t0_ns"] <= r["t1_ns"]
    one, two = by["call.one"][0], by["call.two"][0]
    assert one["parent"] is None and one["call"] == one["id"]
    assert two["parent"] is None and two["call"] == two["id"] != one["id"]
    assert one["attrs"] == {"n": 4}
    tx1, tx2 = by["tx"]
    assert (tx1["parent"], tx1["call"]) == (one["id"], one["id"])
    assert (tx2["parent"], tx2["call"]) == (two["id"], two["id"])
    fib, inner = by["fiber"][0], by["inner"][0]
    assert fib["attrs"] == {"kind": "fiber", "steps": 7}
    assert (inner["parent"], inner["call"]) == (fib["id"], one["id"])
    assert one["t0_ns"] <= fib["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= fib["t1_ns"] <= one["t1_ns"]
    # closed inner spans come first
    assert [r["name"] for r in recs][-1] == "call.two"
    assert root is not None


def test_span_shares_the_clock_of_the_trace(recording):
    """A span around a torch operation holds that operation's event in a
    CPU torch.profiler trace: both read one clock."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(2**16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mul"):
            y = torch.mul(x, 3.0)
    (rec,) = profiling.drain()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mul"]
    assert rec["t0_ns"] <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= rec["t1_ns"]
    assert float(y[0]) == 3.0
    # no span is a host event of the trace
    assert not any(e.name() == "mul"
                   for e in prof.profiler.kineto_results.events())


def test_annotate_records_a_span_only_while_recording():
    profiling.record(False)
    with profiling.annotate("region"):
        pass
    assert profiling.drain() == []
    profiling.record(True)
    try:
        with profiling.annotate("region"):
            with profiling.span("inside"):
                pass
        recs = profiling.drain()
    finally:
        profiling.record(False)
    by = {r["name"]: r for r in recs}
    assert set(by) == {"region", "inside"}
    assert by["inside"]["parent"] == by["region"]["id"]
