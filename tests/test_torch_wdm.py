"""The port's WDM sweeps (``LinkProgram.dsp_wdm``, ``dsp_wdm_ppm``) against
the JAX package's, and against the port's own per-channel calls.

Sizes: 3-4 channels of 2^9 slots at sps 16; M = 8 for PPM.  Against JAX
(its per-channel draws of ``seed + c`` injected through ``noise=``): equal
error counts, thresholds rel 1e-5, eye scalars rel 1e-4 (float32 reductions
in another order).  Sweep against per-channel call of the port: the sweep
runs the chain channel by channel and the receivers row by row, so error
and step counts are equal and thresholds and eye scalars agree to rel 1e-6.
"""
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, jax_hdd_uniform

from opticomlib_tpu import link as jlink
from opticomlib_tpu.params import SimParams as JParams
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch.ops import kernels
from opticomlib_tpu_torch.ops.prbs import prbs
from opticomlib_tpu_torch.params import SimParams as TParams

torch.set_num_threads(2)

SPS, R, NBITS, NCH = 16, 10e9, 2**9, 4
M, K = 8, 3


def _progs(n_bits=NBITS, stages=None, **kw):
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=-18,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                pd_BW=0.75 * R, include_thermal=True, include_shot=False)
    base.update(kw)
    out = []
    for mod, P, dev in ((jlink, JParams, {}), (tlink, TParams,
                                             {"device": "cpu"})):
        st = () if stages is None else (mod.FiberSpec(**stages),)
        out.append(mod.build_link(
            mod.LinkSpec(stages=st, **base), n_bits,
            params=P.create(sps=SPS, R=R, _warn=False), **dev))
    return out


def _tprog(**kw):
    return _progs(**kw)[1]


def _noise(jprog, seed, n_ch, hdd=None):
    out = []
    for c in range(n_ch):
        d = jax_draws(seed + c, jprog.n_bits * SPS, jprog.spec)
        if hdd:
            d["hdd"] = jax_hdd_uniform(seed + c, jprog.n_bits // M, M)
        out.append(d)
    return out


def _bits(n_ch, n):
    return prbs(15, length=n_ch * n)[0].reshape(n_ch, n)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P0", [-18, -22])
def test_dsp_wdm_matches_jax(P0):
    """-18 dBm: a few errors a channel; -22 dBm: a BER of about 0.1."""
    jprog, tprog = _progs(P0=P0)
    bits = _bits(3, NBITS)
    sj = jprog.dsp_wdm(3, bits=bits, seed=11)
    st = tprog.dsp_wdm(3, bits=bits, seed=11, noise=_noise(jprog, 11, 3))
    np.testing.assert_array_equal(st.n_errors, sj.n_errors)
    np.testing.assert_array_equal(st.ber, sj.ber)
    np.testing.assert_allclose(st.threshold, sj.threshold, rtol=1e-5)
    for k in ("mu0", "mu1", "s0", "s1", "er", "eye_h"):
        np.testing.assert_allclose(getattr(st, k), getattr(sj, k),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert st.n_errors.dtype == np.int64 and st.ber.shape == (3,)
    assert st.rin_ok.all() and st.n_channels == 3
    np.testing.assert_array_equal(st.tx, sj.tx)


@pytest.mark.parametrize("decision", ["soft", "hard"])
def test_dsp_wdm_ppm_matches_jax(decision):
    jprog, tprog = _progs(n_bits=NBITS * M, P0=-20)
    bits = _bits(3, NBITS * K)
    sj = jprog.dsp_wdm_ppm(3, M=M, decision=decision, bits=bits, seed=4)
    st = tprog.dsp_wdm_ppm(3, M=M, decision=decision, bits=bits, seed=4,
                           noise=_noise(jprog, 4, 3, hdd=True))
    np.testing.assert_array_equal(st.n_errors, sj.n_errors)
    assert (st.n_errors > 0).any()
    if decision == "hard":
        np.testing.assert_allclose(st.threshold, sj.threshold, rtol=1e-5)
    else:
        assert st.threshold is None and sj.threshold is None
    assert st.decision == decision and st.M == M
    np.testing.assert_array_equal(st.tx, sj.tx)


def test_dsp_wdm_ppm_soft_sweep_through_fiber():
    """tests/test_link_wdm.py::test_dsp_wdm_ppm_soft_sweep without its mesh:
    a 10 km span at fixed h, default PRBS bits, high SNR."""
    n_sym = 64
    jprog, tprog = _progs(
        n_bits=n_sym * M, P0=5, pd_BW=7.5e9,
        stages=dict(length=10, alpha=0.2, beta_2=-21.0, gamma=1.3, h=1.0))
    sj = jprog.dsp_wdm_ppm(4, M=M, seed=0)
    st = tprog.dsp_wdm_ppm(4, M=M, seed=0, noise=_noise(jprog, 0, 4))
    assert st.ber.shape == (4,) and (st.ber == 0).all()
    np.testing.assert_array_equal(st.n_errors, sj.n_errors)
    np.testing.assert_array_equal(st.tx, sj.tx)
    one = tprog.dsp_ppm(M, decision="soft", bits=st.tx[2], seed=2)
    assert one.n_errors == st.n_errors[2]
    assert st.n_steps == [(10,)] * 4


# ---------------------------------------------------------------------------
# the sweep against the port's per-channel calls
# ---------------------------------------------------------------------------
def test_channel_waveforms_are_the_per_channel_runs():
    """Channel c is the chain of seed + c: the same waveform, bit for bit
    (one channel at a time, nothing batched in the chain)."""
    tprog = _tprog(P0=-22)
    bits = _bits(NCH, NBITS)
    wins, slots, steps, flags = tprog._sweep(bits, 11, None, 8192, None)
    assert wins.shape == (NCH, NBITS * SPS) and slots.shape == (NCH, NBITS)
    for c in range(NCH):
        run = tprog.run(bits=bits[c], seed=11 + c)
        assert torch.equal(wins[c], run.v.signal)
        assert torch.equal(slots[c], run.slots.signal)
        assert steps[c] == run.n_steps


def test_channels_equal_per_channel_dsp():
    # ~1e-1 BER: plenty of errors per channel (and a negative mu0: er NaN)
    tprog = _tprog(P0=-22)
    bits = _bits(NCH, NBITS)
    kernels.reset_launches()
    sweep = tprog.dsp_wdm(NCH, bits=bits, seed=11)
    assert sweep.ber.shape == (NCH,)
    for c in range(NCH):
        d = tprog.dsp(bits=bits[c], seed=11 + c, sps_resamp=None)
        assert d.ber > 0
        assert sweep.n_errors[c] == d.n_errors, c
        assert sweep.n_steps[c] == d.n_steps, c
        assert sweep.threshold[c] == pytest.approx(d.threshold, rel=1e-6), c
        for k in ("mu0", "mu1", "s0", "s1", "er", "eye_h"):
            assert getattr(sweep, k)[c] == pytest.approx(
                getattr(d.eye, k), rel=1e-6, nan_ok=True), (k, c)
    assert kernels.LAUNCHES["histogram2d"] == 0  # CPU: the plain version


def test_wdm_ppm_hard_equals_dsp_ppm_per_channel():
    """tests/test_link_ppm.py::TestWdmPpmHard: the same receiver a channel,
    seed + c, the same keyed HDD draw."""
    n_ch = 3
    tprog = _tprog(n_bits=NBITS * M, P0=-20)
    bits = _bits(n_ch, NBITS * K)
    sw = tprog.dsp_wdm_ppm(n_ch, M=M, decision="hard", bits=bits, seed=4)
    assert sw.decision == "hard" and sw.threshold is not None
    for c in range(n_ch):
        d = tprog.dsp_ppm(M, decision="hard", bits=bits[c], seed=4 + c)
        assert sw.n_errors[c] == d.n_errors, c
        assert sw.threshold[c] == pytest.approx(d.threshold, rel=1e-6), c


def test_wdm_ppm_hard_noiseless_zero_ber():
    tprog = _tprog(n_bits=NBITS * M, P0=5, include_thermal=False)
    sw = tprog.dsp_wdm_ppm(2, M=M, decision="hard", seed=0)
    assert (sw.ber == 0).all()


def test_default_bits_are_distinct_per_channel():
    jprog, tprog = _progs()
    sweep = tprog.dsp_wdm(NCH, seed=0)
    assert sweep.tx.shape == (NCH, NBITS)
    assert any((sweep.tx[0] != sweep.tx[c]).any() for c in range(1, NCH))
    np.testing.assert_array_equal(sweep.tx, jprog.dsp_wdm(NCH, seed=0).tx)


def test_noiseless_all_channels_error_free():
    sweep = _tprog(P0=5, include_thermal=False).dsp_wdm(NCH, seed=0)
    assert (sweep.n_errors == 0).all()


@pytest.mark.parametrize("call", [
    lambda p: p.dsp_wdm(0),
    lambda p: p.dsp_wdm(NCH, bits=np.zeros((NCH, NBITS - 1))),
    lambda p: p.dsp_wdm(2, noise=[{}]),
    lambda p: p.dsp_wdm_ppm(0, M=M),
    lambda p: p.dsp_wdm_ppm(2, M=3),
    lambda p: p.dsp_wdm_ppm(2, M=M, decision="nope"),
    lambda p: p.dsp_wdm_ppm(2, M=M, bits=np.zeros((2, 5))),
])
def test_validation(call):
    with pytest.raises(ValueError):
        call(_tprog())


@pytest.mark.parametrize("call", [
    lambda p: p.dsp_wdm(2, mesh=object()),
    lambda p: p.dsp_wdm_ppm(2, M=M, mesh=object()),
])
def test_mesh_is_not_ported(call):
    with pytest.raises(NotImplementedError, match="parallel"):
        call(_tprog())
