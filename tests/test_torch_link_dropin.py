"""The fused link as a drop-in for the JAX package's: ``build_link(spec,
n_bits)`` under ``gv(...)`` (parameters and device from ``gv``, the card
unless the CPU is named), the result of ``LinkProgram.run`` (``tx`` a
``BinarySequence``, ``v`` and ``slots`` ``ElectricalSignal``, ``program``,
``decide`` and ``ber``), and the ``(bits_f32, seed) -> (v, slots, ...)``
entry ``LinkProgram.jitted``.

The cases of tests/test_link.py (B2B and fiber+EDFA BER, the standard host
DSP on the fused output, reproducibility, AC coupling, nrz and rcos pulses,
a wrong bit count) run through both packages on the JAX program's own noise
draws (rebuilt along its key stream): ``ber()`` and ``decide()`` come out
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, rel_l2

from opticomlib_tpu import gv as jgv
from opticomlib_tpu import link as jlink
from opticomlib_tpu.models import ook as jook
from opticomlib_tpu_torch import gv, link as tlink, ook as took
from opticomlib_tpu_torch.signals import BinarySequence, ElectricalSignal

torch.set_num_threads(2)

SPS, R, NBITS, SEED = 16, 10e9, 2**10, 7


@pytest.fixture(autouse=True)
def _gv():
    for g in (jgv, gv):
        g.default()
    jgv(sps=SPS, R=R, N=NBITS)
    gv(sps=SPS, R=R, N=NBITS, device="cpu")
    yield
    for g in (jgv, gv):
        g.default()


def _specs(**over):
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5.0,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=0.75 * R)
    stages = over.pop("stages", None)
    out = []
    for mod in (jlink, tlink):
        kw = dict(base, **over)
        if stages == "fiber_edfa":
            kw["stages"] = (mod.FiberSpec(length=50, alpha=0.2, beta_2=-21.0,
                                          gamma=1.3), mod.EDFASpec(G=10, NF=5))
        out.append(mod.LinkSpec(**kw))
    return out


def _both(n_bits=NBITS, seed=SEED, **over):
    """The JAX result and the port's on the JAX program's draws."""
    js, ts = _specs(**over)
    jprog = jlink.build_link(js, n_bits=n_bits)
    tprog = tlink.build_link(ts, n_bits=n_bits)      # params, device: gv's
    rj = jprog.run(seed=seed)
    rt = tprog.run(seed=seed, noise=jax_draws(seed, tprog.n, js))
    return rj, rt, jprog, tprog


def test_build_link_takes_params_and_device_from_gv(monkeypatch):
    """``build_link(spec, n_bits)`` under ``gv(...)``: ``gv``'s parameters,
    ``gv``'s device; with no device named that is the card, and without one
    it raises (no quiet CPU run)."""
    _, ts = _specs()
    prog = tlink.build_link(ts, NBITS)
    assert prog.params == gv.params and prog.n == NBITS * SPS
    assert prog.device.type == "cpu" and prog.Hp.device.type == "cpu"
    assert tlink.build_link(ts, NBITS, return_field=True).return_field
    other = gv.params.replace(sps=8)
    assert tlink.build_link(ts, NBITS, other).params.sps == 8
    assert tlink.build_link(ts, NBITS, params=other, device="cpu").n == 8 * NBITS
    gv.default()
    gv(sps=SPS, R=R, N=NBITS)            # no device named
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlink.build_link(ts, NBITS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlink.build_link(ts, NBITS, device="cuda")
    assert tlink.build_link(ts, NBITS, device="cpu").device.type == "cpu"


def test_run_result_has_the_jax_members():
    rj, rt, _, tprog = _both()
    assert isinstance(rt.tx, BinarySequence)
    assert isinstance(rt.v, ElectricalSignal)
    assert isinstance(rt.slots, ElectricalSignal)
    assert rt.program is tprog and rt.rin_ok is True
    assert rt.v.size == NBITS * SPS and rt.slots.size == NBITS
    assert rt.v.dtype == torch.float32 and rt.v.device.type == "cpu"
    np.testing.assert_array_equal(rt.tx.data, rj.tx.data)
    assert rel_l2(rt.v.to_numpy(), rj.v.to_numpy()) <= 1e-4
    assert set(vars(rj)) <= set(vars(rt))


@pytest.mark.parametrize("case,limit", [
    (dict(), 1e-3),                                  # B2B at high SNR
    (dict(stages="fiber_edfa"), 1e-2),
    (dict(coupling="AC", include_thermal=False, include_shot=False), None),
    (dict(pulse_shape="nrz"), 0.05),
    (dict(pulse_shape="rcos", pulse_kwargs=(("beta", 0.25),)), 0.05),
])
def test_ber_and_decide_equal_jax(case, limit):
    n_bits = 2**9 if case.get("pulse_shape") in ("nrz", "rcos") else NBITS
    jgv(N=n_bits, sps=SPS, R=R)
    gv(N=n_bits, sps=SPS, R=R)
    rj, rt, _, _ = _both(n_bits=n_bits, **case)
    assert rt.v.size == n_bits * SPS
    bj, bt = rj.ber(), rt.ber()
    assert bt == bj
    if limit is not None:
        assert bt < limit
    th = float(np.median(rj.slots.to_numpy()))
    dj, dt = rj.decide(th), rt.decide(th)
    assert isinstance(dt, BinarySequence)
    # a slot within round-off of the threshold may fall on either side
    near = np.abs(rj.slots.to_numpy() - th) <= 1e-4 * abs(th)
    assert np.array_equal(dt.data[~near], dj.data[~near])
    assert rt.ber(th) == float(np.mean(dt.data != rt.tx.data))


def test_dsp_threshold_consistency():
    """The fused output drives the standard host DSP (GET_EYE path)."""
    rj, rt, _, _ = _both()
    rx, eye_obj, rth = took.DSP(rt.v)
    assert took.BER_analizer("counter", Tx=rt.tx, Rx=rx) < 1e-3
    assert eye_obj.er > 10
    _, eye_j, rth_j = jook.DSP(rj.v)
    assert abs(rth - rth_j) <= abs(eye_j.mu1 - eye_j.mu0) / 999 * (1 + 1e-3)


def test_reproducible_and_bad_bits_length():
    _, ts = _specs(lw=1e5)
    prog = tlink.build_link(ts, NBITS)
    a, b = prog.run(seed=5), prog.run(seed=5)
    np.testing.assert_array_equal(a.v.to_numpy(), b.v.to_numpy())
    with pytest.raises(ValueError, match="need 1024 bits"):
        prog.run(bits=np.zeros(17, np.uint8))
    tx = BinarySequence(np.arange(NBITS) % 2)
    # a BinarySequence goes in
    np.testing.assert_array_equal(prog.run(bits=tx).tx.data, tx.data)


def test_dsp_results_carry_tx_as_binary_sequence():
    js, ts = _specs()
    jprog, tprog = jlink.build_link(js, NBITS), tlink.build_link(ts, NBITS)
    dj, dt = jprog.dsp(seed=1), tprog.dsp(seed=1)
    assert isinstance(dt.tx, BinarySequence)
    np.testing.assert_array_equal(dt.tx.data, dj.tx.data)
    pj = jprog.dsp_ppm(8, seed=1)
    pt = tprog.dsp_ppm(8, seed=1)
    assert isinstance(pt.tx, BinarySequence)
    np.testing.assert_array_equal(pt.tx.data, pj.tx.data)


def test_jitted_entry_is_the_chain():
    """``prog.jitted(bits_f32, seed) -> (v, slots, ...)``, the JAX program's
    entry of that name: tensors in, tensors out, equal to ``run``'s."""
    js, ts = _specs()
    jprog, tprog = jlink.build_link(js, NBITS), tlink.build_link(ts, NBITS)
    bits = np.zeros(NBITS, np.float32)
    bits[::2] = 1.0
    draws = jax_draws(3, tprog.n, js)
    out = tprog.jitted(torch.from_numpy(bits), 3, noise=draws)
    v, slots = out[:2]
    assert v.dtype == torch.float32 and slots.shape == (NBITS,)
    assert not v.requires_grad
    v_j, slots_j = jprog.jitted(jnp.asarray(bits), jnp.uint32(3))[:2]
    assert rel_l2(v.numpy(), v_j) <= 1e-4
    assert rel_l2(slots.numpy(), slots_j) <= 1e-4
    res = tprog.run(bits=bits, noise=draws)
    assert torch.equal(res.v.signal, v) and torch.equal(res.slots.signal, slots)
    assert torch.equal(tprog.jitted(torch.from_numpy(bits), 3)[0],
                       tprog(torch.from_numpy(bits), seed=3)[0])
