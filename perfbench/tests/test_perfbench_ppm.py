"""The M-PPM cell ``ppm8_20km.ppm_hard_2e24`` on the CPU at 2^8 symbols x
8 slots x 32 samples: a sound run is ``correct``; a run whose timed path
is broken underneath is not.  The faults are the OOK cells' (a frozen
fiber, half the waveform, an error count altered), a wrong bit, a repair
count altered, and two of the photodiode's noise at the cell's own 16 dBm:
the noise left out, and the thermal draw shifted by one sample.  At this
power the noise is about 1e-3 of the voltage's norm and decides no symbol,
so only ``v_rel_l2`` sees these two, the shift the least (its draw
differs little from the low-passed noise a sample away).  The HDD scores
are a function of the information bits alone.  The cell's CPU size is in
``conftest.SMALL`` (entered by ``perfbench/conftest.py``)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from opticomlib_tpu_torch import link
from perfbench import run
from perfbench.pbcore import cells, draws, ppm
from perfbench.tests import test_perfbench_correct as ook_faults
from perfbench.tests.conftest import small

CELL = "ppm8_20km.ppm_hard_2e24"
SEED = 2**33 + 4049


def _run(**more):
    return run.run_cell(CELL, SEED, 0.0, False, device="cpu",
                        overrides=small(CELL, **more), log=lambda m: None)


def test_sound_run_is_correct():
    out = _run(check_calls=2)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(ppm.NAMES)
    assert set(out["metrics"]) >= {"setup_s", "samples_per_s"}


def test_traced_run_on_the_cpu_reads_no_device_metric():
    """The CPU has no device trace, and runs the eye eagerly: the share of
    graph replays reads 0 and is the only metric."""
    out = run.run_cell(CELL, SEED + 1, 0.2, True, device="cpu",
                       overrides=small(CELL, trace_seconds=0.1),
                       log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {"rx.eye_graph_pct": {"value": 0.0,
                                                   "unit": "%"}}


def _wrong_bit(monkeypatch):
    """The program sends its first symbol in the next slot."""
    encode = link.PPM_ENCODER

    def moved(bits, M):
        out = encode(bits, M)
        out.data[:M] = np.roll(out.data[:M], 1)
        return out
    monkeypatch.setattr(link, "PPM_ENCODER", moved)


def _altered(index):
    """The hard decision's ``index``-th count one off where it is
    produced."""
    def fault(monkeypatch):
        decide = link._ppm_hard_decide

        def off(*a):
            out = list(decide(*a))
            out[index] = out[index] + 1
            return tuple(out)
        monkeypatch.setattr(link, "_ppm_hard_decide", off)
    return fault


def _noise(fault):
    """The photodiode's unit draw ``normal(name, sigma)`` broken as
    ``fault(name, normal, sigma)`` says, where the receiver takes it."""
    def patch(monkeypatch):
        receive = link.LinkProgram._receive

        def broken(self, field, normal):
            return receive(self, field,
                           lambda name, sigma: fault(name, normal, sigma))
        monkeypatch.setattr(link.LinkProgram, "_receive", broken)
    return patch


FAULTS = {"frozen_fiber": ook_faults._frozen_fiber,
          "half_waveform": ook_faults._half_waveform,
          "wrong_bit": _wrong_bit,
          "errors_altered": _altered(1), "repairs_altered": _altered(2),
          "noise_omitted": _noise(lambda name, normal, sigma: 0.0),
          "wrong_draw": _noise(lambda name, normal, sigma: (
              torch.roll(normal(name, sigma), 1) if name == "thermal"
              else normal(name, sigma)))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run()
    assert not out["correct"], (fault, out["checks"])
    if fault in ("noise_omitted", "wrong_draw"):
        assert [k for k, c in out["checks"].items()
                if c["value"] > c["limit"]] == ["v_rel_l2"], out["checks"]


def test_hdd_scores_follow_the_information_bits():
    rows = draws.bits_pool(SEED, 2, 1, 64)[:, 0]
    a, b = (ppm.info_bits(r, 8) for r in rows)
    assert a.size == 24 and (a == rows[0][:24]).all()
    s = ppm.hdd_scores(a, 8, "cpu")
    assert s.shape == (8, 8) and s.dtype == torch.float32
    assert torch.equal(s, ppm.hdd_scores(a.copy(), 8, "cpu"))
    assert not torch.equal(s, ppm.hdd_scores(b, 8, "cpu"))
    assert 0 <= float(s.min()) and float(s.max()) < 1


def test_cell_reads_the_graph_share_from_the_answers():
    c = cells.cell(CELL)
    (reader,) = [r for m, r in c.per_layer if m["name"] == "rx.eye_graph_pct"]
    calls = [[{"eye_graph": True}], [{"eye_graph": False}],
             [{"eye_graph": True}], [{"eye_graph": True}]]
    assert reader.read(SimpleNamespace(calls=calls)) == 75.0
    assert reader.read(SimpleNamespace(calls=[[{"n_errors": 0}]])) is None
    assert reader.read(SimpleNamespace(calls=[])) is None
