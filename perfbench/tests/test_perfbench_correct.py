"""``correct`` on the CPU at small sizes: the program against the plain
reference passes in every cell; the comparison fails when the timed path
is broken underneath (a split step that returns its field unchanged, half
of the waveform or of the channels left out, the error count altered where
it is produced) and when the bfloat16 reference stands in for the
program (the control).  The card's look is skipped (``device="cpu"``);
the rest of a run is the benchmark's own."""
import pytest
import torch

from opticomlib_tpu_torch import link
from opticomlib_tpu_torch.ops import ssfm
from perfbench import run
from perfbench.pbcore import cells, compare, draws
from perfbench.tests.conftest import SMALL, SWEEP, small

SEED = 2**32 + 77
DSP_CELLS = ["ook_50km.dsp_2e24", "longhaul_dbp.dsp_2e24"]


def _run(cell, **more):
    return run.run_cell(cell, SEED, 0.0, False, device="cpu",
                        overrides=small(cell, **more), log=lambda m: None)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["count"] == cells.cell(cell).chips
    assert set(out["metrics"]) >= {"setup_s", "samples_per_s"}
    assert list(out)[-1] == "checks"


def test_sound_sweep_is_correct():
    out = _run("ook_50km.dsp_2e24", **SWEEP)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_traced_run_is_correct():
    cell = "longhaul_dbp.dsp_2e24"
    out = run.run_cell(cell, SEED + 1, 0.5, True, device="cpu",
                       overrides=small(cell, trace_seconds=0.1),
                       log=lambda m: None)
    assert out["correct"] and out["attempted"] >= 1, out["checks"]
    # the CPU has no device trace: every device metric is left out
    assert out["metrics"] == {} and "busy_s" not in out["device"]


def _frozen_fiber(monkeypatch):
    """Every split step returns its field unchanged."""
    monkeypatch.setattr(ssfm, "_nl_l_nl_step", lambda A, *a, **k: A)
    monkeypatch.setattr(ssfm, "_strang_step", lambda A, *a, **k: A)


def _half_waveform(monkeypatch):
    """The second half of the voltage is the first half again."""
    receive = link.LinkProgram._receive

    def half(self, field, normal):
        v = receive(self, field, normal)
        h = v.shape[-1] // 2
        return torch.cat([v[:h], v[:h]])
    monkeypatch.setattr(link.LinkProgram, "_receive", half)


def _half_channels(monkeypatch):
    """A sweep runs only the first half of its channels."""
    channels = link.LinkProgram._channels
    monkeypatch.setattr(link.LinkProgram, "_channels",
                        lambda self, n, mesh, axis: channels(
                            self, n // 2, mesh, axis))


def _errors_altered(monkeypatch):
    """The error count is one off where the receiver produces it."""
    decide = link._ook_decide
    monkeypatch.setattr(link, "_ook_decide",
                        lambda *a: (lambda r, e: (r, e + 1))(*decide(*a)))


FAULTS = {"frozen_fiber": _frozen_fiber, "half_waveform": _half_waveform,
          "errors_altered": _errors_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", DSP_CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", ["half_channels", "frozen_fiber",
                                   "errors_altered"])
def test_broken_sweep_is_not_correct(monkeypatch, fault):
    dict(FAULTS, half_channels=_half_channels)[fault](monkeypatch)
    out = _run("ook_50km.dsp_2e24", **SWEEP)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", DSP_CELLS)
def test_control_is_not_correct(cell):
    """The bfloat16 reference in the program's place fails a limit."""
    c = cells.cell(cell)
    traffic = dict(c.traffic, samples=SMALL[cell])
    n = traffic["samples"]
    bits = draws.bits_pool(SEED, 1, 1, n // c.cfg["params"]["sps"])[0][0]
    d = draws.make(c.cfg, n, draws.derive(SEED, draws.DRAWS, 0), "cpu")
    ref = c.reference.run(c.cfg, traffic, bits, d, "cpu")
    low = c.reference.run(c.cfg, traffic, bits, d, "cpu",
                          precision="bfloat16")
    r = compare.row(c.entry, low, low["v"], ref)
    assert not compare.judge(r, c.limits), r
    assert compare.judge(compare.row(c.entry, ref, ref["v"], ref), c.limits)


def test_perturbed_voltage_fails():
    c = cells.cell("ook_50km.dsp_2e24")
    traffic = dict(c.traffic, samples=SMALL["ook_50km.dsp_2e24"])
    n = traffic["samples"]
    bits = draws.bits_pool(SEED, 1, 1, n // 64)[0][0]
    d = draws.make(c.cfg, n, 5, "cpu")
    ref = c.reference.run(c.cfg, traffic, bits, d, "cpu")
    v = ref["v"].clone()
    v[::97] *= 1.2
    assert not compare.judge(compare.row(c.entry, ref, v, ref), c.limits)


def test_a_missing_answer_or_limit_fails():
    c = cells.cell("ook_50km.dsp_2e24")
    assert not compare.judge(compare.row(c.entry, None, None, None), c.limits)
    ok = {k: 0 for k in c.entry.NAMES}
    assert compare.judge(ok, c.limits)
    assert not compare.judge(dict(ok, extra=0), c.limits)
    assert not compare.judge({k: 0 for k in c.entry.NAMES[1:]}, c.limits)


def test_set_limits_reads_sound_under_and_control_over_the_limits():
    from perfbench import set_limits
    cell = "longhaul_dbp.dsp_2e24"
    c = cells.cell(cell)
    r = set_limits.readings(cell, [SEED + 2], [SEED + 3], device="cpu",
                            overrides=small(cell), log=lambda m: None)
    assert compare.judge(r["lower"], c.limits), r["lower"]
    assert not compare.judge(r["upper"], c.limits), r["upper"]
