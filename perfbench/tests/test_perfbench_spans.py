"""The join of the program's spans with the device trace
(:mod:`perfbench.pbcore.spans`) on made-up traces, the span metrics'
readers, and a traced run with spans on the CPU at a small size."""
from types import SimpleNamespace

import pytest

from perfbench.pbcore import cells, spans, trace
from perfbench.tests.conftest import small

US = 1000  # ns
SPAN_METRICS = ("fiber.busy_ms_per_call", "fiber.idle_ms_per_call",
                "rx.busy_ms_per_call", "rx.idle_ms_per_call",
                "rx.readbacks_per_call", "setup.link_build_s")


def _rec(name, i, parent, call, a, b, **attrs):
    return dict(name=name, id=i, parent=parent, call=call, t0_ns=a * US,
                t1_ns=b * US, attrs=attrs)


def _patch(monkeypatch, ev):
    """Serve ``ev`` (``(name, is_device, start_us, end_us, corr)``) to both
    the join and the trace's summary."""
    ev = [(n, d, a * US, b * US, c) for n, d, a, b, c in ev]
    monkeypatch.setattr(spans, "_events", lambda prof: ev)
    monkeypatch.setattr(trace, "_raw", lambda prof: [e[:4] for e in ev])


#: one call (id 1): ``tx`` then ``fiber`` (with a nested ``fiber``-less
#: gap) then ``rx.eye``, ``rx.readback``
CALL = [_rec("call.dsp", 1, None, 1, 0, 100),
        _rec("tx", 2, 1, 1, 1, 10),
        _rec("fiber", 3, 1, 1, 10, 50, kind="fiber", steps=2),
        _rec("rx.eye", 4, 1, 1, 55, 80),
        _rec("rx.readback", 5, 1, 1, 80, 99)]

#: launches on the host, device work behind them
EVENTS = [
    ("cudaLaunchKernel", False, 2, 4, 11),         # tx's kernel
    ("cudaLaunchKernel", False, 12, 14, 12),       # fiber's kernels,
    ("cudaLaunchKernel", False, 15, 17, 13),       # queued ahead
    ("tx_kernel", True, 5, 20, 11),
    ("fft", True, 20, 40, 12),                     # runs while the host
    ("nl", True, 40, 45, 13),                      # is still in fiber
    ("cudaMemcpyAsync", False, 46, 49, 14),        # the step's read-back
    ("Memcpy DtoH (Device -> Pageable)", True, 47, 48, 14),
    ("cudaLaunchKernel", False, 60, 62, 15),
    ("hist", True, 70, 75, 15),                    # eye; idle 48-70
    ("cudaMemcpyAsync", False, 85, 88, 16),
    ("Memcpy DtoH (Device -> Pageable)", True, 86, 87, 16),
    ("Memset (Device)", True, 90, 91, 99),         # launch not traced
    ("cudaStreamSynchronize", False, 95, 120, 0),  # after the call
]


def test_ops_go_to_the_span_of_their_launch(monkeypatch):
    """``tx_kernel`` and ``fft`` ran on the device while the host sat in
    ``fiber``, but were launched in ``tx``: their launches place them, not
    their device times; ``nl`` was launched in ``fiber``."""
    ev = EVENTS[:6]
    # the fiber's launches made inside tx on the host: ops follow them
    ev[1] = ("cudaLaunchKernel", False, 6, 7, 12)
    _patch(monkeypatch, ev)
    cut = spans.by_span(None, CALL, (0, 200 * US))
    assert cut["calls"] == 1
    assert cut["launches_by_span"] == {"tx": 2, "fiber": 1}
    assert cut["busy_by_span"]["tx"] == pytest.approx(35e-6)   # 5-40
    assert cut["busy_by_span"]["fiber"] == pytest.approx(5e-6)


def test_idle_gap_split_across_spans_and_outside(monkeypatch):
    """The device idles 48-70 while the host closes ``fiber`` (50), runs
    the call's own code (50-55) and opens ``rx.eye``; after the call (100-
    120) only ``outside`` is open."""
    _patch(monkeypatch, EVENTS)
    cut = spans.by_span(None, CALL, (0, 200 * US))
    idle = cut["idle_by_span"]
    assert idle["fiber"] == pytest.approx(4e-6)          # 45-47, 48-50
    assert idle["call.dsp"] == pytest.approx(6e-6)       # 50-55, 99-100
    assert idle["rx.eye"] == pytest.approx(15e-6 + 5e-6)  # 55-70, 75-80
    assert idle[spans.OUTSIDE] == pytest.approx(20e-6)   # 100-120
    assert idle["rx.readback"] == pytest.approx(
        (86 - 80 + 90 - 87 + 99 - 91) * 1e-6)
    # the window opens at the first event (2); 2-5 is tx's
    assert idle["tx"] == pytest.approx(3e-6)
    assert cut["readbacks_by_span"] == {"fiber": 1, "rx.readback": 1}
    assert cut["launches_by_span"] == {"tx": 1, "fiber": 2, "rx.eye": 1}
    assert cut["busy_by_span"][spans.UNLINKED] == pytest.approx(1e-6)


def test_call_cut_by_the_window_is_left_out(monkeypatch):
    """A second call still open when the trace stopped counts for nothing:
    its time and its operations go to ``outside``."""
    late = [_rec("call.dsp", 6, None, 6, 101, 300),
            _rec("fiber", 7, 6, 6, 102, 290)]
    ev = EVENTS + [("cudaLaunchKernel", False, 103, 104, 17),
                   ("fft", True, 104, 130, 17)]
    _patch(monkeypatch, ev)
    cut = spans.by_span(None, CALL + late, (0, 200 * US))
    assert cut["calls"] == 1
    assert cut["launches_by_span"]["fiber"] == 2
    assert cut["launches_by_span"][spans.OUTSIDE] == 1
    assert cut["busy_by_span"][spans.OUTSIDE] == pytest.approx(26e-6)
    # a window that holds both calls counts both
    whole = spans.by_span(None, CALL + late, (0, 400 * US))
    assert whole["calls"] == 2 and whole["launches_by_span"]["fiber"] == 3


@pytest.mark.parametrize("window", [(0, 200), (0, 50)])
def test_spans_conserve_the_trace(monkeypatch, window):
    """Busy and idle by span (``outside`` and ``unlinked`` included) add up
    to the summary's busy time and idle time; read-backs to its ``dtoh``,
    launches to its kernels; with no call counted, all of it is
    ``outside``."""
    _patch(monkeypatch, EVENTS)
    s = trace.summarize(None, 1)
    cut = spans.by_span(None, CALL, (window[0] * US, window[1] * US))
    assert sum(cut["busy_by_span"].values()) == pytest.approx(s["busy_s"])
    assert cut["busy_s"] == pytest.approx(s["busy_s"])
    assert sum(cut["idle_by_span"].values()) == pytest.approx(
        s["window_s"] - s["busy_s"])
    assert sum(cut["readbacks_by_span"].values()) == s["dtoh"]
    assert sum(cut["launches_by_span"].values()) == s["kernels"]
    if window[1] == 50:
        assert cut["calls"] == 0
        assert set(cut["idle_by_span"]) == {spans.OUTSIDE}


def test_empty_trace_gives_nothing(monkeypatch):
    _patch(monkeypatch, [])
    assert spans.by_span(None, CALL, (0, 1)) is None


def test_innermost_pieces():
    recs = [_rec("root", 1, None, 1, 0, 100), _rec("a", 2, 1, 1, 10, 20),
            _rec("b", 3, 1, 1, 30, 60), _rec("c", 4, 3, 1, 40, 40),
            _rec("d", 5, 3, 1, 45, 50), _rec("r2", 6, None, 6, 200, 300)]
    pieces = [(a // US, b // US, n) for a, b, n in spans._innermost(recs)]
    assert pieces == [(0, 10, "root"), (10, 20, "a"), (20, 30, "root"),
                      (30, 40, "b"), (40, 45, "b"), (45, 50, "d"),
                      (50, 60, "b"), (60, 100, "root"), (200, 300, "r2")]


def _readers():
    return {m: cells.load_module(cells.HERE / "metrics" / (m + ".py"),
                                 "metric") for m in SPAN_METRICS}


def test_span_readers(monkeypatch):
    _patch(monkeypatch, EVENTS)
    cut = spans.by_span(None, CALL, (0, 200 * US))
    build = _rec("setup.build_link", 9, None, 9, 0, 2_500_000, n=64)
    ctx = SimpleNamespace(spans=CALL + [build], span_cut=cut)
    r = {m: mod.read(ctx) for m, mod in _readers().items()}
    assert r["fiber.busy_ms_per_call"] == pytest.approx(
        1e3 * cut["busy_by_span"]["fiber"])
    assert r["fiber.idle_ms_per_call"] == pytest.approx(4e-3)
    rx = ("rx.eye", "rx.readback")
    assert r["rx.busy_ms_per_call"] == pytest.approx(
        1e3 * sum(cut["busy_by_span"].get(k, 0) for k in rx))
    assert r["rx.idle_ms_per_call"] == pytest.approx(
        1e3 * sum(cut["idle_by_span"][k] for k in rx))
    assert r["rx.readbacks_per_call"] == 1
    assert r["setup.link_build_s"] == pytest.approx(2.5)


def test_span_readers_find_nothing_without_spans():
    """What the run gives where the program records no spans (or the
    harness passes none): every span reader returns None."""
    for ctx in (SimpleNamespace(), SimpleNamespace(spans=None,
                                                   span_cut=None),
                SimpleNamespace(spans=[], span_cut=dict(
                    calls=0, busy_by_span={}, idle_by_span={},
                    readbacks_by_span={}))):
        assert all(mod.read(ctx) is None for mod in _readers().values())


def test_traced_run_with_spans_on_the_cpu():
    """``run_spans.traced_run`` on the CPU at a small size: every traced
    call is counted, the span metrics are read (no device time on the
    CPU), and the recorder is off afterwards."""
    from opticomlib_tpu_torch.utils import profiling
    from perfbench import run_spans
    cell = "ook_50km.dsp_2e24"
    out = run_spans.traced_run(cell, 2**31 + 11, 0.2, device="cpu",
                               overrides=small(cell))
    info = out["spans"]
    assert info["calls"] == out["attempted"] >= 1
    assert info["records"] >= 8 * info["calls"] + 1
    assert set(SPAN_METRICS) <= set(out["metrics"])
    assert out["metrics"]["fiber.busy_ms_per_call"]["value"] == 0.0
    assert out["metrics"]["rx.readbacks_per_call"]["value"] == 0.0
    assert out["metrics"]["setup.link_build_s"]["value"] > 0
    assert info["busy_s"] == 0 and info["idle_s"] == pytest.approx(
        info["trace_idle_s"])
    assert out["correct"] is True
    assert profiling.drain() == []
    off = run_spans.traced_run(cell, 2**31 + 11, 0.2, record=False,
                               device="cpu", overrides=small(cell))
    assert not set(SPAN_METRICS) & set(off["metrics"])
    assert off["spans"]["records"] == 0
