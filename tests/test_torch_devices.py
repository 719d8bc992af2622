"""The port's staged devices (opticomlib_tpu_torch.devices) against the JAX
package's (opticomlib_tpu.devices): each device on the same input, with the
legacy noise of both drawn under one ``np.random.seed`` (so both see the
same numbers), at 2^10-2^12 bits; then the physics invariants and the
validation of tests/test_devices.py.

Tolerances, each against the JAX output:
* float64 devices (LASER, PM, MZM, BPF, EDFA, DM, LPF, PD, ADC): the same
  dtype, within 1e-9 of the largest sample (torch and NumPy FFTs and
  transcendentals round differently in the last bits);
* DAC: the kernel route shapes in float32, within 2e-6 of the largest
  sample; the FFT route in float64, within 1e-9;
* FIBER (complex64): the same step count, relative L2 <= 1e-4 (float32 FFT
  round-off over the steps);
* GET_EYE: the JAX device engine's scalars within 1e-4 relative (float32
  reductions in another order), the host engine's within 2e-4 relative and
  2e-5 absolute (tests/test_eye_device.py's bounds), the instant exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import opticomlib_tpu as J
from opticomlib_tpu import devices as JD
from opticomlib_tpu import signals as js
from opticomlib_tpu_torch import devices as TD
from opticomlib_tpu_torch import gv as tgv, rng as trng
from opticomlib_tpu_torch import signals as ts

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset():
    """A fresh ``gv`` on the CPU (its default device is the card)."""
    tgv.default()
    tgv.device = "cpu"
    trng.clear()
    yield
    tgv.default()


def _gv(**kw):
    J.gv(**kw)
    tgv(**kw)


def _arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, atol_rel):
    t, j = _arr(t), _arr(j)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=atol_rel * max(np.abs(j).max(), 1e-300))


def _compare(t, j, atol_rel=1e-9):
    """Port and JAX signals agree: signal, noise (or both NULL), n_pol."""
    _close(t.signal, j.signal, atol_rel)
    if j.noise is js.NULL:
        assert t.noise is ts.NULL
    else:
        _close(t.noise, j.noise, atol_rel)
    assert getattr(t, "n_pol", 1) == getattr(j, "n_pol", 1)


def _both(fn, seed=5):
    """``fn(devices, signals)`` through both packages, each after
    ``np.random.seed(seed)``."""
    np.random.seed(seed)
    j = fn(JD, js)
    np.random.seed(seed)
    t = fn(TD, ts)
    return t, j


def _field(mod, n, pol=1, seed=0, noise=False):
    r = np.random.default_rng(seed)
    shape = (n,) if pol == 1 else (2, n)
    s = 0.05 * (1 + r.normal(size=shape) + 1j * r.normal(size=shape))
    no = 1e-3 * (r.normal(size=shape) + 1j * r.normal(size=shape))
    return mod.OpticalSignal(s, no if noise else mod.NULL, n_pol=pol)


# -------------------------------------------------------------------- DAC
@pytest.mark.parametrize("kw,tol", [
    (dict(pulse_shape="nrz"), 2e-6),
    (dict(pulse_shape="nrz", T=3, Vpp=5, offset=-2.5), 2e-6),
    (dict(pulse_shape="gaussian", Vpp=5, offset=-2.5), 2e-6),
    (dict(pulse_shape="gaussian", T=2, m=2, coupling="AC"), 2e-6),
    (dict(pulse_shape="gaussian", c=0.3), 1e-9),
    (dict(pulse_shape="rcos", beta=0.3, rcos_type="sqrt"), 2e-6),
    (dict(h=np.hanning(9)), 2e-6),
    (dict(pulse_shape="gaussian", BW=3e9), 2e-6),
], ids=["nrz", "nrz_T3", "gaussian", "supergauss_ac", "chirped", "rrc",
        "custom_h", "gaussian_bw"])
@pytest.mark.parametrize("nbits", [2**10, 2**10 + 1])
def test_dac_matches_jax(kw, tol, nbits):
    _gv(sps=16, R=10e9, N=nbits)
    bits = np.random.default_rng(nbits).integers(0, 2, nbits)
    t, j = _both(lambda D, S: D.DAC(bits, **kw))
    _compare(t, j, tol)


def test_dac_long_rcos_takes_the_fft_route():
    """At 2^10 bits the raised cosine spans 1020 slots: 16,321 taps, past
    the kernel's limit, so the float64 FFT convolution runs."""
    _gv(sps=16, R=10e9, N=2**10)
    bits = np.random.default_rng(0).integers(0, 2, 2**10)
    t, j = _both(lambda D, S: D.DAC(bits, pulse_shape="rcos"))
    _compare(t, j, 1e-9)


# ------------------------------------------------------------ TX / optics
@pytest.mark.parametrize("kw", [dict(), dict(lw=1e6), dict(lw=0, rin=-140),
                                dict(lw=2e5, rin=-150, df=1e9)],
                         ids=["cw", "phase", "lw0_rin", "all"])
def test_laser_matches_jax(kw):
    _gv(sps=16, R=10e9, N=2**10)
    t, j = _both(lambda D, S: D.LASER(P0=3, **kw))
    _compare(t, j)


def test_laser_legacy_draw_order():
    """A walk is drawn for lw=0 too: the RIN after it is the same draw."""
    _gv(sps=16, R=10e9, N=2**8)
    np.random.seed(9)
    TD.LASER(P0=0, lw=0, rin=-140)
    after_t = np.random.random()
    np.random.seed(9)
    JD.LASER(P0=0, lw=0, rin=-140)
    assert after_t == np.random.random()


@pytest.mark.parametrize("pol", [1, 2])
def test_modulators_match_jax(pol):
    _gv(sps=16, R=10e9, N=2**10)
    n = 2**10 * 16
    drive = 2.5 * np.sin(np.linspace(0, 40, n))

    def mzm(D, S):
        return D.MZM(_field(S, n, pol, noise=True), drive, bias=-2.5, Vpi=5,
                     loss_dB=3, ER_dB=26, pol="y", BW=20e9)

    _compare(*_both(mzm))
    _compare(*_both(lambda D, S: D.PM(_field(S, n, pol, noise=True), drive)))
    _compare(*_both(lambda D, S: D.PM(_field(S, n, pol), 1.3)))
    _compare(*_both(lambda D, S: D.MZM(_field(S, n, pol), 1.0, bias=0.5)))


def test_edfa_bpf_dm_match_jax():
    _gv(sps=16, R=10e9, N=2**10)
    n = 2**10 * 16
    for pol in (1, 2):
        _compare(*_both(lambda D, S: D.EDFA(_field(S, n, pol, noise=True),
                                            G=16, NF=5, BW=30e9)))
        _compare(*_both(lambda D, S: D.EDFA(_field(S, n, pol), G=10, NF=4)))
        _compare(*_both(lambda D, S: D.BPF(_field(S, n, pol, True), BW=2e9)))
    t, j = _both(lambda D, S: D.DM(_field(S, n, 1, noise=True), D=336.0,
                                   retH=True))
    _compare(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1])


# ------------------------------------------------------------------ FIBER
@pytest.mark.parametrize("kw", [
    dict(),
    dict(h=5.0),
    dict(method="o4", h=10.0),
    dict(method="o4"),
    dict(method="local_error"),
    dict(beta_2=0.0),
], ids=["adaptive", "fixed_h", "o4_fixed", "o4_auto", "local_error",
        "linear_only_quirk"])
@pytest.mark.parametrize("pol", [1, 2])
def test_fiber_matches_jax(kw, pol):
    _gv(sps=16, R=10e9, N=2**10)
    n = 2**10 * 16
    cfg = dict(length=50, alpha=0.2, beta_2=-20, gamma=2)
    cfg.update(kw)
    t = TD.FIBER(_field(ts, n, pol, noise=True), **cfg)
    j = JD.FIBER(_field(js, n, pol, noise=True), **cfg)
    assert t.signal.dtype == torch.complex64 and t.noise is ts.NULL
    a, b = t.signal.numpy(), np.asarray(j.signal)
    assert a.dtype == b.dtype and t.n_pol == j.n_pol == pol
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4
    assert t.n_steps == _jax_steps(n, pol, cfg)


def _jax_steps(n, pol, cfg):
    """The JAX package's step count for ``cfg`` on ``_field(js, n, pol)``
    (its staged FIBER does not return it)."""
    from opticomlib_tpu.ops import ssfm as jssfm
    A = np.asarray(_field(js, n, pol, noise=True).to_numpy(), np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n, J.gv.dt)
    kw = {k: cfg.get(k, 0.0) for k in ("alpha", "beta_2", "gamma")}
    L = cfg["length"]
    method, h = cfg.get("method", "reference"), cfg.get("h")
    if h is not None:
        return len(jssfm.ssfm_step_schedule(L, h))
    if method == "local_error":
        return jssfm.ssfm_local_error(A, w, L, **kw)[1]
    phi_w = jssfm.dispersion_phase(w, kw["beta_2"], 0.0)
    a_km = jssfm.alpha_per_km(kw["alpha"])
    re, im = A.real.astype(np.float32), A.imag.astype(np.float32)
    if method == "o4":
        return int(jssfm._ssfm_o4_auto_loop(
            re, im, phi_w, np.float32(L), np.float32(kw["gamma"]),
            np.float32(1e-5), np.float32(L / 10), np.float32(a_km))[2])
    if kw["beta_2"] == 0:
        return 1
    h0 = jssfm.adaptive_h0(0.01, kw["gamma"],
                           float(np.max(re * re + im * im)), L)
    return int(jssfm._ssfm_loop(re, im, phi_w, L, kw["gamma"], 0.01, h0,
                                a_km, adaptive=True)[2])


def test_fiber_dbp_roundtrip():
    _gv(sps=32, R=10e9, N=128)
    x = TD.DAC(ts.BinarySequence("0101100110").data.tolist() * 2,
               pulse_shape="gaussian")
    op = ts.OpticalSignal(x.signal.to(torch.complex128) * 0.1)
    cfg = dict(length=30, alpha=0.2, beta_2=-20, gamma=1.3, phi_max=0.003)
    back = TD.DBP(TD.FIBER(op, **cfg), **cfg)
    np.testing.assert_allclose(back.signal.numpy(), op.signal.numpy(),
                               atol=1e-3)


def test_fiber_not_ported_options():
    _gv(sps=16, R=1e9, N=16)
    op = TD.LASER(P0=1)
    # mesh= is ported (tests/test_torch_parallel.py): what it cannot do is
    # return_steps, as in the JAX device
    with pytest.raises(ValueError, match="mesh= does not support"):
        TD.FIBER(op, length=1, mesh=object(), return_steps=True)
    # return_steps and show_progress are ported now
    # (tests/test_torch_trajectory.py holds them to the JAX device): the
    # trajectory comes back, and the bar warns of nothing
    z, A_z = TD.FIBER(op, length=1, return_steps=True)
    assert z[0] == 0.0 and z[-1] == pytest.approx(1.0)
    assert tuple(A_z.shape) == (z.size, op.size)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TD.FIBER(op, length=1, show_progress=True)


# --------------------------------------------------------------- receiver
@pytest.mark.parametrize("mode", ["all", "ase-only", "thermal-only",
                                  "shot-only", "ase-thermal", "ase-shot",
                                  "thermal-shot", "none"])
@pytest.mark.parametrize("pol", [1, 2])
def test_pd_matches_jax(mode, pol):
    _gv(sps=16, R=10e9, N=2**10)
    n = 2**10 * 16
    t, j = _both(lambda D, S: D.PD(_field(S, n, pol, noise=True), BW=7.5e9,
                                   include_noise=mode, T=250, Fn=3))
    _compare(t, j)


@pytest.mark.parametrize("kw", [dict(n=8), dict(n=4, otype="n"),
                                dict(fs=40e9, n=6)])
def test_adc_lpf_matches_jax(kw):
    _gv(sps=16, R=10e9, N=2**10)
    r = np.random.default_rng(1)
    v = np.repeat(r.integers(0, 2, 2**10), 16) + 0.05 * r.normal(
        size=2**14)
    t, j = _both(lambda D, S: D.ADC(D.LPF(S.ElectricalSignal(v), 5e9), **kw))
    _compare(t, j, 1e-12)
    t, j = _both(lambda D, S: D.LPF(S.ElectricalSignal(v, 0.1 * v), 5e9,
                                    retH=True))
    _compare(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1])


def _eye_input(mod, sps=16, nbits=2048):
    r = np.random.default_rng(4)
    x = np.repeat(r.integers(0, 2, nbits), sps).astype(float)
    k = np.exp(-0.5 * (np.arange(-2 * sps, 2 * sps + 1) / (0.3 * sps)) ** 2)
    x = np.convolve(x, k / k.sum(), mode="same")
    return mod.ElectricalSignal(0.05 + 0.9 * x,
                                np.where(x > 0.5, 0.06, 0.09)
                                * r.normal(size=x.size))


@pytest.mark.parametrize("sps_resamp", [None, 64])
def test_get_eye_matches_jax(sps_resamp):
    _gv(sps=16, R=10e9, N=2048)
    t = TD.GET_EYE(_eye_input(ts), nslots=1024, sps_resamp=sps_resamp)
    dev = JD.GET_EYE(_eye_input(js), nslots=1024, sps_resamp=sps_resamp,
                     engine="device")
    host = JD.GET_EYE(_eye_input(js), nslots=1024, sps_resamp=sps_resamp,
                      engine="host")
    for k in ("mu0", "mu1", "s0", "s1", "threshold", "t_opt", "t_left",
              "t_right", "er", "eye_h"):
        np.testing.assert_allclose(getattr(t, k), getattr(dev, k),
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(getattr(t, k), getattr(host, k),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    assert t.i == dev.i == host.i and isinstance(t.i, int)
    assert t.sps == 16 and t.dt == J.gv.dt and t.execution_time > 0
    np.testing.assert_allclose(t.y, np.asarray(dev.y), rtol=1e-4, atol=1e-5)
    assert isinstance(TD.GET_EYE(_eye_input(ts), nslots=64,
                                 engine="host").mu1, float)


def test_sampler_matches_jax():
    _gv(sps=4, R=1e9, N=3)
    t, j = _both(lambda D, S: D.SAMPLER(D.DAC("010", Vpp=1), instant=2))
    _compare(t, j, 2e-6)
    np.testing.assert_allclose(t.signal.numpy(), [0, 1, 0], atol=1e-6)


# ------------------------------------------------- invariants (test_devices)
def test_mzm_extinction_and_loss():
    tgv(R=1e9, N=20, sps=512)
    op = ts.OpticalSignal(np.ones(tgv.N * tgv.sps)) * J.idbm(0) ** 0.5
    el = np.sin(2 * np.pi * tgv.R * tgv.t) * 2.5
    mzm = TD.MZM(op, el, bias=2.5, Vpi=5, loss_dB=2, ER_dB=30, pol="x")
    p_in = J.dbm(float(op.power()))
    a = mzm.abs("signal").numpy()
    np.testing.assert_allclose(J.dbm(a.min() ** 2), p_in - 32, atol=1e-6)
    np.testing.assert_allclose(J.dbm(a.max() ** 2), p_in - 2, atol=1e-6)


def test_edfa_gain_and_ase_power():
    tgv(sps=16, R=1e9, N=4096)
    np.random.seed(1)
    op = TD.LASER(P0=10)
    out = TD.EDFA(op, G=20.0, NF=5.0)
    assert out.n_pol == 2
    np.testing.assert_allclose(out.abs("signal")[0].numpy(),
                               op.abs("signal").numpy() * 10, rtol=1e-9)
    assert torch.all(out.signal[1] == 0)
    from scipy.constants import h as hpl
    P_ase = 10 ** 0.5 * hpl * tgv.f0 * (100 - 1) * tgv.fs
    np.testing.assert_allclose(float(np.sum(out.power("W", "noise"))), P_ase,
                               rtol=0.1)


def test_get_eye_statistics_and_sampler():
    tgv(sps=32, R=1e9)
    np.random.seed(4)
    bits = np.random.randint(0, 2, 512)
    x = TD.DAC(bits.tolist(), pulse_shape="nrz", Vpp=1)
    x = ts.ElectricalSignal(x.signal.numpy()
                            + np.random.normal(0, 0.03, x.size))
    e = TD.GET_EYE(x, nslots=512)
    assert abs(e.mu1 - 1) < 0.05 and abs(e.mu0) < 0.05
    assert abs(e.s0 - 0.03) < 0.02 and abs(e.s1 - 0.03) < 0.02
    assert 0.2 < e.threshold < 0.8
    assert e.eye_h == pytest.approx(e.mu1 - 3 * e.s1 - e.mu0 - 3 * e.s0)


# -------------------------------------------------------------- validation
_INVALID = [
    lambda D, S: D.DAC("010", pulse_shape="triangle"),
    lambda D, S: D.DAC("010", Vpp=50),
    lambda D, S: D.DAC("010", offset=50),
    lambda D, S: D.DAC("010", pulse_shape="gaussian", T=0),
    lambda D, S: D.DAC("010", pulse_shape="gaussian", T=3 * 16),
    lambda D, S: D.DAC("010", pulse_shape="gaussian", T=8, m=0),
    lambda D, S: D.DAC("010", Vpp="5"),
    lambda D, S: D.DAC("010", pulse_shape="gaussian", T=8.5),
    lambda D, S: D.DAC("010", pulse_shape="gaussian", c="x"),
    lambda D, S: D.DAC("010", pulse_shape="nrz", T=True),
    lambda D, S: D.DAC("010", coupling="XY"),
    lambda D, S: D.DAC("012"),
    lambda D, S: D.LASER(P0=0, df=1e12),
    lambda D, S: D.LASER(P0=0, rin=20),
    lambda D, S: D.PM(S.ElectricalSignal(np.ones(5)), el_input=1),
    lambda D, S: D.PM(S.OpticalSignal(np.ones(5)), np.ones((2, 5))),
    lambda D, S: D.MZM(S.ElectricalSignal(np.ones(5)), 3),
    lambda D, S: D.MZM(S.OpticalSignal(np.ones(5)), [1, 2, 3]),
    lambda D, S: D.MZM(S.OpticalSignal(np.ones(5)), 3, pol="z"),
    lambda D, S: D.MZM(S.OpticalSignal(np.ones(5)), np.ones((2, 5))),
    lambda D, S: D.BPF(S.ElectricalSignal(np.ones(5)), 1e9),
    lambda D, S: D.EDFA(S.ElectricalSignal(np.ones(5)), 10, 5),
    lambda D, S: D.EDFA(S.OpticalSignal(np.ones(5)), -3, 5),
    lambda D, S: D.DM(S.ElectricalSignal(np.ones(5)), 100),
    lambda D, S: D.FIBER(S.ElectricalSignal(np.ones(5)), 1),
    lambda D, S: D.FIBER(S.OpticalSignal(np.ones(5)), 1, method="bogus"),
    lambda D, S: D.FIBER(S.OpticalSignal(np.ones(5)), 1, method="o4",
                         return_steps=True),
    lambda D, S: D.LPF(np.ones((2, 5)), 1e9),
    lambda D, S: D.PD(S.ElectricalSignal([1, 2, 3]), BW=5e9),
    lambda D, S: D.PD(S.OpticalSignal(np.ones(5)), BW=5e9, r=0),
    lambda D, S: D.PD(S.OpticalSignal(np.ones(5)), BW=5e9, r="1"),
    lambda D, S: D.PD(S.OpticalSignal(np.ones(5)), BW=5e9, T=-10),
    lambda D, S: D.PD(S.OpticalSignal(np.ones(5)), BW=5e9, R_load=-50),
    lambda D, S: D.PD(S.OpticalSignal(np.ones(5)), BW=5e9,
                      include_noise=True),
    lambda D, S: D.PD(S.OpticalSignal(np.ones(5)), BW=5e9,
                      include_noise="loud"),
    lambda D, S: D.ADC(S.ElectricalSignal(np.arange(10.0)), otype="q"),
    lambda D, S: D.ADC(S.ElectricalSignal(np.arange(1.0))),
    lambda D, S: D.GET_EYE(np.ones((2, 2, 2))),
]


@pytest.mark.parametrize("case", range(len(_INVALID)))
def test_validation_matches_jax(case):
    _gv(sps=16, R=1e9, N=16)
    fn = _INVALID[case]
    with pytest.raises(Exception) as jerr:
        fn(JD, js)
    with pytest.raises(Exception) as terr:
        fn(TD, ts)
    assert terr.type is jerr.type
    assert str(terr.value) == str(jerr.value)
