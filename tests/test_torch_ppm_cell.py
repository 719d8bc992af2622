"""BASELINE config 3 as the benchmark runs it (``perfbench`` cell
``ppm8_20km.ppm_hard_2e24``), on the CPU at 2^8 symbols x 8 slots x 32
samples: ``dsp_ppm`` with the optical band-pass against the benchmark's
plain float64 reference (``perfbench/reference/ppm8_20km.py``) under the
cell's own limits, the controls that must fail them, the HDD repair count,
and the spans of the two PPM receivers."""
import copy
import math

import numpy as np
import pytest
import torch

from opticomlib_tpu_torch import link
from opticomlib_tpu_torch.utils import profiling
from perfbench import run
from perfbench.pbcore import cells, compare, draws, ppm

torch.set_num_threads(2)

CELL = "ppm8_20km.ppm_hard_2e24"
N_SYM, M, SPS = 2**8, 8, 32
SEED = 2**32 + 2021
#: a launch power at which the slicer errs and the repair decides symbols
NOISY_P0 = -16.0


def _cell(P0=None, bpf=True):
    c = cells.cell(CELL, dict(samples=N_SYM * M * SPS))
    c.cfg = copy.deepcopy(c.cfg)
    if P0 is not None:
        c.cfg["link"]["P0"] = P0
    if not bpf:
        c.cfg["link"]["stages"] = [st for st in c.cfg["link"]["stages"]
                                   if st["spec"] != "BPFSpec"]
    return c


def _inputs(c, seed):
    """A call's pool row, unit draws and HDD scores, made as ``run.py``
    makes them."""
    n = c.traffic["samples"]
    row = draws.bits_pool(seed, 1, 1, n // SPS)[0][0]
    d = draws.call_draws(c.cfg, n, 1, seed, draws.CALL, 0, "cpu")[0]
    info = ppm.info_bits(row, M)
    return row, d, info, ppm.hdd_scores(info, M, "cpu")


def _dsp_ppm(c, decision, seed=SEED):
    """The program's ``dsp_ppm`` on the inputs of ``seed`` and its voltage;
    the reference's answers on the same inputs."""
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    vs = []
    prog.register_forward_hook(lambda _m, _i, out: vs.append(out[0]))
    row, d, info, hdd = _inputs(c, seed)
    r = prog.dsp_ppm(M, decision, bits=info, seed=7, nslots=8192,
                     noise=dict(d, hdd=hdd))
    ref = c.reference.run(c.cfg, dict(c.traffic, decision=decision), row, d,
                          "cpu")
    return r, vs[-1], ref


def _v_rel(v, ref):
    vr = ref["v"]
    return float(torch.linalg.vector_norm(v.to(vr) - vr)
                 / torch.linalg.vector_norm(vr))


@pytest.mark.parametrize("P0", [None, NOISY_P0], ids=["cell", "noisy"])
@pytest.mark.parametrize("decision", ["hard", "soft"])
def test_dsp_ppm_holds_to_the_reference(decision, P0):
    """Errors and repairs exact, the step count exact, the voltage within
    the cell's limit; for the hard receiver the eye's levels within the
    cell's limit and the threshold within two of the KDE's 500 grid steps
    plus the flat stretch of the density around its minimum."""
    c = _cell(P0)
    r, v, ref = _dsp_ppm(c, decision)
    lim = c.limits
    assert r.n_errors == ref["n_errors"]
    assert r.n_repaired == ref["n_repaired"]
    assert list(r.n_steps) == ref["n_steps"]
    assert _v_rel(v, ref) <= lim["v_rel_l2"]
    if decision == "soft":
        assert r.n_repaired is None and r.threshold is None
        return
    e = r.eye
    assert max(abs(getattr(e, k) - ref[k]) / abs(ref[k])
               for k in ("mu0", "mu1", "s0", "s1")) <= lim["eye_rel"]
    step = abs(ref["mu1"] - ref["mu0"]) / 499
    assert abs(r.threshold - ref["threshold"]) <= (
        2 * step + e.threshold_plateau)
    if P0 == NOISY_P0:   # the repair and the decoder are exercised
        assert r.n_errors > 0 and r.n_repaired > 0
    else:
        assert r.n_errors == 0 and r.n_repaired == 0


def test_cell_answers_are_correct_and_the_controls_are_not():
    """The entry's answers pass the cell's limits; the reference computed
    in bfloat16 fails one, and so does the program without the band-pass,
    held to the reference with it, by its voltage."""
    c = _cell()
    row, d, _, _ = _inputs(c, SEED + 1)
    ref = c.reference.run(c.cfg, c.traffic, row, d, "cpu")
    low = c.reference.run(c.cfg, c.traffic, row, d, "cpu",
                          precision="bfloat16")
    assert not compare.judge(compare.row(c.entry, low, low["v"], ref),
                             c.limits)
    for bpf in (True, False):
        cc = _cell(bpf=bpf)
        prog = run.build_program(cc, cc.traffic, torch.device("cpu"))[0]
        vs = []
        prog.register_forward_hook(lambda _m, _i, out: vs.append(out[0]))
        ans = cc.entry.call(prog, row[None], 7, [d], cc.traffic)
        got = compare.row(c.entry, ans[0], vs[-1], ref)
        assert compare.judge(got, c.limits) == bpf, got
        if not bpf:
            assert got["v_rel_l2"] > c.limits["v_rel_l2"]


@pytest.mark.parametrize("fault", ["omitted", "shifted"])
def test_noise_faults_at_the_cell_power_fail_the_voltage_limit(fault):
    """At the cell's 16 dBm the photodiode's noise decides no symbol; the
    cell's voltage limit still fails the program with that noise left out
    or with its thermal draw shifted by one sample, and no other limit
    does."""
    c = _cell()
    row, d, info, hdd = _inputs(c, SEED + 4)
    noise = dict(d, hdd=hdd)
    if fault == "omitted":
        noise.update(thermal=torch.zeros_like(d["thermal"]),
                     shot=torch.zeros_like(d["shot"]))
    else:
        noise["thermal"] = torch.roll(d["thermal"], 1)
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    vs = []
    prog.register_forward_hook(lambda _m, _i, out: vs.append(out[0]))
    r = prog.dsp_ppm(M, "hard", bits=info, seed=7, nslots=8192, noise=noise)
    ref = c.reference.run(c.cfg, c.traffic, row, d, "cpu")
    got = compare.row(c.entry, ppm.answer(r, False), vs[-1], ref)
    assert [k for k in c.entry.NAMES if got[k] > c.limits[k]] == [
        "v_rel_l2"], got


@pytest.mark.parametrize("wrong", ["thermal", "hdd"])
def test_a_wrong_draw_moves_the_noisy_answers(wrong):
    """Where the noise decides symbols, the program on a draw other than
    the reference's (the thermal draw shifted by a sample, or the HDD
    scores of other bits) gives other errors or repairs than the reference.
    (The shot noise of a -16 dBm launch is far below the thermal noise.)"""
    c = _cell(NOISY_P0)
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    row, d, info, hdd = _inputs(c, SEED)
    noise = dict(d, hdd=hdd)
    if wrong == "hdd":
        noise["hdd"] = ppm.hdd_scores(1 - info, M, "cpu")
    else:
        noise[wrong] = torch.roll(d[wrong], 1)
    r = prog.dsp_ppm(M, "hard", bits=info, seed=7, nslots=8192, noise=noise)
    ref = c.reference.run(c.cfg, c.traffic, row, d, "cpu")
    assert (r.n_errors, r.n_repaired) != (ref["n_errors"],
                                          ref["n_repaired"])


@pytest.mark.parametrize("on_counts", [[0, 1, 3], [1, 1, 1], [2, 0, 8, 1]])
def test_n_repaired_counts_the_symbols_the_repair_decides(on_counts):
    """A forced slicer output: symbol s has ``on_counts[s]`` slots above
    the threshold.  ``n_repaired`` is the hand count of symbols with other
    than one ON slot; a single ON slot is kept, the others are decided by
    the scores (the highest ON score, else the highest score)."""
    gen = torch.Generator().manual_seed(5)
    n_sym = len(on_counts)
    samp = torch.full((n_sym, M), 0.1)
    for s, k in enumerate(on_counts):
        samp[s, torch.randperm(M, generator=gen)[:k]] = 0.9
    u = torch.rand((n_sym, M), generator=gen)
    on = samp > 0.5
    want_pos = torch.where(on.any(1), torch.where(on, u, -1.0).argmax(1),
                           u.argmax(1))
    info = ((want_pos[:, None] >> torch.arange(2, -1, -1)) & 1).reshape(-1)
    m = {k: torch.tensor(x) for k, x in dict(
        mu0=0.1, mu1=0.9, s0=0.05, s1=0.05, threshold=0.5).items()}
    rth, n_err, n_rep = link._ppm_hard_decide(m, samp.reshape(-1), info, M,
                                              u)
    assert float(rth) == 0.5
    assert int(n_rep) == sum(k != 1 for k in on_counts)
    assert int(n_err) == 0
    # with the threshold undefined the scan between the levels takes over
    m["threshold"] = torch.tensor(float("nan"))
    rth, _, n_rep = link._ppm_hard_decide(m, samp.reshape(-1), info, M, u)
    assert 0.1 < float(rth) < 0.9
    assert int(n_rep) == sum(k != 1 for k in on_counts)


def _spans(fn):
    profiling.record(True)
    try:
        out = fn()
        recs = profiling.drain()
    finally:
        profiling.record(False)
    return out, recs


def _tree(recs):
    """``(root, {child name: [records]})``; every record in the root's
    call."""
    (root,) = [r for r in recs if r["parent"] is None]
    kids = {}
    for r in recs:
        assert r["call"] == root["id"]
        if r is not root:
            kids.setdefault(r["name"], []).append(r)
    return root, kids


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


@pytest.mark.parametrize("decision", ["hard", "soft"])
def test_dsp_ppm_spans_and_results_unchanged_by_recording(decision):
    c = _cell(NOISY_P0)
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    _, d, info, hdd = _inputs(c, SEED + 2)

    def call():
        return prog.dsp_ppm(M, decision, bits=info, seed=3, nslots=8192,
                            noise=dict(d, hdd=hdd))
    off = call()
    on, recs = _spans(call)
    root, kids = _tree(recs)
    assert root["name"] == "call.dsp_ppm"
    want = {"tx", "fiber", "stage", "rx.pd", "rx.decide", "rx.readback"}
    attrs = dict(n=N_SYM * M * SPS, M=M, decision=decision)
    if decision == "hard":
        want.add("rx.eye")
        attrs["n_repaired"] = off.n_repaired
        assert kids["rx.eye"][0]["attrs"] == {"graph": "eager"}
    assert set(kids) == want and root["attrs"] == attrs
    assert kids["stage"][0]["attrs"] == {"kind": "bpf"}
    assert kids["fiber"][0]["attrs"]["steps"] == off.n_steps[0]
    for k in ("n_errors", "n_repaired", "threshold", "n_steps", "rin_ok"):
        assert _same(getattr(on, k), getattr(off, k)), k
    if decision == "hard":
        for k in ("mu0", "mu1", "s0", "s1", "threshold_plateau"):
            assert getattr(on.eye, k) == getattr(off.eye, k), k


@pytest.mark.parametrize("decision", ["hard", "soft"])
def test_dsp_wdm_ppm_spans_and_per_channel_repairs(decision):
    """Two channels: one ``call.dsp_wdm_ppm`` root over both chains, one
    ``rx.eye`` on the stacked windows (hard), a decision a channel and one
    read-back; the results equal with recording off, and each channel's
    ``n_errors`` and ``n_repaired`` equal ``dsp_ppm``'s on its seed and
    draws."""
    c = _cell(NOISY_P0)
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    ins = [_inputs(c, SEED + 3 + ch) for ch in range(2)]
    bits = np.stack([x[2] for x in ins])
    noise = [dict(x[1], hdd=x[3]) for x in ins]

    def call():
        return prog.dsp_wdm_ppm(2, M, decision, bits=bits, seed=4,
                                noise=noise)
    off = call()
    on, recs = _spans(call)
    root, kids = _tree(recs)
    assert root["name"] == "call.dsp_wdm_ppm"
    assert root["attrs"]["channels"] == 2
    assert [len(kids[k]) for k in ("tx", "fiber", "stage", "rx.pd",
                                   "rx.decide", "rx.readback")] == [
        2, 2, 2, 2, 2, 1]
    assert len(kids.get("rx.eye", [])) == (decision == "hard")
    for k in ("n_errors", "n_repaired", "threshold", "n_steps", "ber"):
        assert _same(getattr(on, k), getattr(off, k)), k
    for ch in range(2):
        one = prog.dsp_ppm(M, decision, bits=bits[ch], seed=4 + ch,
                           noise=noise[ch])
        assert off.n_errors[ch] == one.n_errors
        if decision == "hard":
            assert off.n_repaired[ch] == one.n_repaired
    if decision == "hard":
        assert root["attrs"]["n_repaired"] == int(off.n_repaired.sum()) > 0
    else:
        assert off.n_repaired is None
