"""BASELINE config 5 as the benchmark runs it on one card (``perfbench``
cell ``ook_50km.wdm16_2e26``), on the CPU at 4 channels x 2^8 bits x 64:
the configuration ``ook_50km_wdm16`` (config 2's link at config 5's
size), the ``sweep`` entry against the benchmark's plain float64 reference
(``perfbench/reference/ook_50km_wdm16.py``) under the cell's own limits, the
faults that must fail them, the sweep's ``sweep.channel`` spans and
``SWEEP_COUNTS``, and the two readers of the cell's span metrics on a
hand-made trace."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from opticomlib_tpu_torch import link
from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.utils import profiling
from perfbench import run
from perfbench.pbcore import cells, draws

torch.set_num_threads(2)

CELL = "ook_50km.wdm16_2e26"
C, N = 4, 2**14
SEED = 2**32 + 2027
SMALL = {"traffic": dict(channels=C, samples=N, warmup_calls=1,
                         check_calls=1)}


@pytest.fixture(autouse=True)
def _recording_off():
    """Span recording off after each test (the ``sweep`` entry's build
    turns it on)."""
    yield
    profiling.record(False)


def _run(seed=SEED):
    return run.run_cell(CELL, seed, 0.0, False, device="cpu",
                        overrides=SMALL, log=lambda m: None)


def test_cell_files_load_by_name():
    c = cells.cell(CELL)
    assert (c.config, c.chips) == ("ook_50km_wdm16", 1)
    assert c.traffic["samples"] == 2**26 and c.traffic["channels"] == 16
    assert c.traffic["sps_resamp"] is None and c.traffic["nslots"] == 8192
    assert c.entry.__name__.endswith("_sweep")
    assert set(c.limits) == set(c.entry.NAMES)
    assert {m["name"] for m, _ in c.end_to_end} == {"samples_per_s",
                                                   "setup_s"}
    assert {m["name"] for m, _ in c.per_layer} >= {
        "kernels.roofline_pct", "rx.eye_graph_pct",
        "sweep.fiber_busy_ms_per_step", "sweep.idle_ms_per_channel"}


def test_configuration_is_config_2s_link_at_config_5s_size():
    """Each channel runs ``ook_50km``'s link, value for value, and the
    deployment's size is the traffic's: 16 channels of 2^20 bits x 64."""
    c = cells.cell(CELL)
    config2 = cells.cell("ook_50km.dsp_2e24").cfg
    for key in ("params", "link", "precision", "guarantees"):
        assert c.cfg[key] == config2[key], key
    assert c.cfg["source"] != config2["source"]
    d, sps = c.cfg["deployment"], c.cfg["params"]["sps"]
    assert d["channels"] == c.traffic["channels"]
    assert d["samples_a_channel"] == c.traffic["samples"]
    assert d["bits_a_channel"] * sps == d["samples_a_channel"] == 2**26
    assert c.reference.run is cells.cell("ook_50km.dsp_2e24").reference.run


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["steps_diff"]["value"] == 0
    assert out["checks"]["n_errors_diff"]["value"] == 0


def _chain_skipped(monkeypatch):
    """Channel 1's chain is not run: channel 0's runs in its place."""
    channels = link.LinkProgram._channels
    monkeypatch.setattr(link.LinkProgram, "_channels",
                        lambda self, n, mesh, axis: [
                            0 if c == 1 else c
                            for c in channels(self, n, mesh, axis)])


def _frozen_fiber(monkeypatch):
    """Every split step returns its field unchanged."""
    monkeypatch.setattr(ssfm, "_nl_l_nl_step", lambda A, *a, **k: A)


def _errors_altered(monkeypatch):
    """Channel 2's error count is one off where the receiver makes it."""
    decide, seen = link._ook_decide, []

    def altered(*a):
        rth, n_err = decide(*a)
        seen.append(1)
        return rth, n_err + (len(seen) % C == 3)
    monkeypatch.setattr(link, "_ook_decide", altered)


FAULTS = {"chain_skipped": _chain_skipped, "frozen_fiber": _frozen_fiber,
          "errors_altered": _errors_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_sweep_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run(SEED + 1)
    assert not out["correct"], (fault, out["checks"])


# ---------------------------------------------------------------------------
# the sweep's spans and counter
# ---------------------------------------------------------------------------
def _program():
    c = cells.cell(CELL, SMALL["traffic"])
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    profiling.record(False)
    bits = draws.bits_pool(SEED, 1, C, N // 64)[0]
    noise = draws.call_draws(c.cfg, N, C, SEED, draws.CALL, 0, "cpu")
    return prog, bits, noise


def _recorded(fn):
    profiling.record(True)
    profiling.drain()
    try:
        out = fn()
        recs = profiling.drain()
    finally:
        profiling.record(False)
    return out, recs


def _channels_of(recs):
    """The ``sweep.channel`` spans in run order, and the names of the
    spans directly inside each."""
    by_parent = {}
    for r in recs:
        by_parent.setdefault(r["parent"], []).append(r)
    chans = sorted((r for r in recs if r["name"] == "sweep.channel"),
                   key=lambda r: r["t0_ns"])
    return chans, [[k["name"] for k in sorted(by_parent.get(r["id"], []),
                                              key=lambda k: k["t0_ns"])]
                   for r in chans]


SWEEPS = {
    "dsp_wdm": lambda prog, bits, noise: prog.dsp_wdm(
        C, bits=bits, seed=5, noise=noise),
    "dsp_wdm_ppm": lambda prog, bits, noise: prog.dsp_wdm_ppm(
        C, 8, "hard", bits=bits[:, :N // 64 // 8 * 3], seed=5,
        noise=noise)}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweep_records_a_span_a_channel(sweep):
    """One ``sweep.channel`` span a channel, in order, under the call's
    root, each around its channel's ``tx``, ``fiber``, ``stage`` and
    ``rx.pd`` with the channel's step counts; the results equal with
    recording off; ``SWEEP_COUNTS`` counts one sweep of ``C`` channels
    each time."""
    prog, bits, noise = _program()
    fn = SWEEPS[sweep]
    before = dict(link.SWEEP_COUNTS)
    off = fn(prog, bits, noise)
    on, recs = _recorded(lambda: fn(prog, bits, noise))
    assert link.SWEEP_COUNTS == dict(sweeps=before["sweeps"] + 2,
                                     channels=before["channels"] + 2 * C)
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "call." + sweep
    chans, inside = _channels_of(recs)
    assert [r["attrs"]["channel"] for r in chans] == list(range(C))
    assert all(r["parent"] == root["id"] for r in chans)
    assert inside == [["tx", "fiber", "stage", "rx.pd"]] * C
    assert [r["attrs"]["steps"] for r in chans] == list(off.n_steps)
    fibers = sorted((r for r in recs if r["name"] == "fiber"),
                    key=lambda r: r["t0_ns"])
    assert [f["attrs"]["steps"] for f in fibers] == [
        s[0] for s in off.n_steps]
    assert [f["parent"] for f in fibers] == [r["id"] for r in chans]
    assert on.n_steps == off.n_steps
    assert np.array_equal(on.n_errors, off.n_errors)
    assert np.array_equal(on.threshold, off.threshold)


def test_dsp_wdm_eye_span_says_how_the_eye_ran():
    prog, bits, noise = _program()
    _, recs = _recorded(lambda: SWEEPS["dsp_wdm"](prog, bits, noise))
    (eye,) = [r for r in recs if r["name"] == "rx.eye"]
    assert eye["attrs"] == {"graph": "eager"}   # the CPU


class _Ops(TorchDispatchMode):
    """Every operation dispatched, by name, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_sweep_spans_launch_read_and_wait_for_nothing(monkeypatch):
    """The sweep dispatches the same operations, read-backs
    (``_local_scalar_dense``) among them, with recording on and off; with
    recording off no span reads the clock.  A first call fills the
    program's caches."""
    prog, bits, noise = _program()
    SWEEPS["dsp_wdm"](prog, bits, noise)

    def ops():
        with _Ops() as mode:
            SWEEPS["dsp_wdm"](prog, bits, noise)
        return mode.names
    on, recs = _recorded(ops)
    assert len([r for r in recs if r["name"] == "sweep.channel"]) == C

    def clock():
        raise AssertionError("a span read the clock")
    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=clock))
    off = ops()
    assert off == on and "_local_scalar_dense.default" in off
    assert profiling.drain() == []


def test_entry_answers_carry_the_calls_spans():
    c = cells.cell(CELL, SMALL["traffic"])
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    bits = draws.bits_pool(SEED, 1, C, N // 64)[0]
    noise = draws.call_draws(c.cfg, N, C, SEED, draws.CALL, 0, "cpu")
    out = c.entry.call(prog, bits, 5, noise, c.traffic)
    assert len(out) == C and all(ch["eye_graph"] is False for ch in out)
    spans = out[0]["spans"]
    assert all("spans" not in ch for ch in out[1:])
    assert [r["attrs"]["steps"] for r in sorted(
        (r for r in spans if r["name"] == "sweep.channel"),
        key=lambda r: r["t0_ns"])] == [tuple(ch["n_steps"]) for ch in out]
    assert profiling.drain() == []


# ---------------------------------------------------------------------------
# the readers of the span metrics
# ---------------------------------------------------------------------------
def _reader(name):
    return cells.load_module(cells.HERE / "metrics" / (name + ".py"),
                             "metric").read


def _rec(name, i, parent, t0, t1, **attrs):
    return dict(name=name, id=i, parent=parent, call=None, t0_ns=t0,
                t1_ns=t1, attrs=attrs)


#: call 1: two channels (0-400: ``tx`` 0-50, ``fiber`` 50-300, ``rx.pd``
#: 300-380; 400-800: ``fiber`` 450-700), a ``fiber`` 800-850 outside any
#: channel and ``rx.eye`` 850-950 under the root 0-1000; call 2 at 10000:
#: one channel 10000-10400 with ``fiber`` 10100-10300 under the root
#: 10000-10500
CALL1 = [_rec("call.dsp_wdm", 1, None, 0, 1000),
         _rec("sweep.channel", 2, 1, 0, 400, channel=0, steps=(3,)),
         _rec("tx", 3, 2, 0, 50), _rec("fiber", 4, 2, 50, 300),
         _rec("rx.pd", 5, 2, 300, 380),
         _rec("sweep.channel", 6, 1, 400, 800, channel=1, steps=(5,)),
         _rec("fiber", 7, 6, 450, 700), _rec("fiber", 8, 1, 800, 850),
         _rec("rx.eye", 9, 1, 850, 950)]
CALL2 = [_rec("call.dsp_wdm", 10, None, 10000, 10500),
         _rec("sweep.channel", 11, 10, 10000, 10400, channel=0, steps=(4,)),
         _rec("fiber", 12, 11, 10100, 10300)]
EVENTS = [(20, 100, "k"), (150, 250, "k"), (280, 350, "k"),
          (300, 420, "k"), (500, 650, "k"), (820, 900, "k"),
          (10100, 10300, "k")]


def _ctx(**more):
    calls = [[dict(n_steps=[3], spans=CALL1), dict(n_steps=[5])],
             [dict(n_steps=[4], spans=CALL2)]]
    return SimpleNamespace(**dict(dict(busy_s=1e-6, calls=calls,
                                       events=EVENTS), **more))


def test_span_readers_count_the_time_inside_the_channels():
    """By hand: the busy time in the channels' ``fiber`` spans is 50 + 100
    + 20 (call 1, channel 0) + 150 (channel 1) + 200 (call 2) = 520 ns
    over 3 + 5 + 4 steps; the busy 820-850 in the ``fiber`` outside a
    channel is not counted.  The idle time in the channels: ``tx`` 0-20,
    their ``fiber`` 100-150, 250-280, 450-500 and 650-700, the channels'
    own 420-450, 700-800, 10000-10100 and 10300-10400: 530 ns over 3
    channels; the idle 900-950 in ``rx.eye`` is not counted."""
    fiber = _reader("sweep.fiber_busy_ms_per_step")
    idle = _reader("sweep.idle_ms_per_channel")
    assert fiber(_ctx()) == pytest.approx(520 / 12 / 1e6)
    assert idle(_ctx()) == pytest.approx(530 / 3 / 1e6)


def test_span_readers_find_nothing_without_a_channel_span():
    """No ``sweep.channel`` span (a program that opens none), no device
    trace (the CPU), no traced call, or a call without spans: ``None``."""
    def renamed(recs):
        return [dict(r, name="stage") if r["name"] == "sweep.channel"
                else r for r in recs]
    bare = [[dict(n_steps=[3], spans=renamed(CALL1)), dict(n_steps=[5])],
            [dict(n_steps=[4], spans=renamed(CALL2))]]
    for name in ("sweep.fiber_busy_ms_per_step",
                 "sweep.idle_ms_per_channel"):
        read = _reader(name)
        assert read(_ctx(calls=bare)) is None
        assert read(_ctx(busy_s=None)) is None
        assert read(_ctx(calls=[])) is None
        assert read(_ctx(calls=_ctx().calls + [[dict(n_steps=[2])]])) \
            is None
