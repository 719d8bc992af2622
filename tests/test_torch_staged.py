"""The README quickstart chain through the port's staged API against the JAX
package's, at N = 2^10 bits x sps 64 (2^16 samples):

    gv(sps=64, R=10e9, wavelength=1550e-9, Vpi=5, N=...)
    PRBS -> DAC(gaussian) -> MZM(LASER) -> FIBER -> PD -> ook.DSP
         -> ook.BER_analizer("counter")

Under one ``np.random.seed`` both packages draw the same PD noise, so the
bounds are tight: the same split-step count, every decided bit equal, the
threshold ``rth`` within 2 of the 1000 grid steps of ``THRESHOLD_EST``
(models/ook.py:26), and the eye's mu0/mu1/s0/s1 within 1e-3 relative (the
JAX DSP measures its eye with the host NumPy engine, the port with the twin
of the device engine; tests/test_eye_device.py holds those two to 2e-4).
With ``gv(seed=...)`` the port draws on-device and is held statistically:
the threshold within 2 %, the level means and spreads within 5 standard
errors.  Also: JAX signals carried into the port (``convert``) and
``BER_analizer``'s estimator mode and ``theory_BER`` against JAX.
"""
import numpy as np
import pytest
import torch

import opticomlib_tpu as J
from opticomlib_tpu import devices as JD
from opticomlib_tpu.models import ook as jook
import opticomlib_tpu_torch as T
from opticomlib_tpu_torch import devices as TD, ook as took
from opticomlib_tpu_torch.convert import gv_from_jax, signal_from_jax

torch.set_num_threads(2)
N_BITS = 2**10
LEVELS = ("mu0", "mu1", "s0", "s1")


@pytest.fixture(autouse=True)
def _reset():
    """A fresh ``gv`` on the CPU (its default device is the card)."""
    T.gv.default()
    T.gv.device = "cpu"
    yield
    T.gv.default()


def _chain(gv, D, ook, np_seed=0, **gv_kw):
    gv(sps=64, R=10e9, wavelength=1550e-9, Vpi=5, N=N_BITS, **gv_kw)
    np.random.seed(np_seed)
    tx = D.PRBS(order=15, len=gv.N)
    v = D.DAC(tx, Vpp=gv.Vpi, offset=-gv.Vpi / 2, pulse_shape="gaussian")
    mod = D.MZM(D.LASER(P0=5), v, bias=-gv.Vpi / 2, Vpi=gv.Vpi, loss_dB=3,
                ER_dB=26)
    fib = D.FIBER(mod, length=50, alpha=0.2, beta_2=-20, gamma=2)
    pdo = D.PD(fib, BW=gv.R * 0.75, r=1, include_noise="all")
    rx, eye, rth = ook.DSP(pdo)
    ber = ook.BER_analizer("counter", Tx=tx, Rx=rx)
    return dict(tx=tx, v=v, fib=fib, pd=pdo, rx=rx, eye=eye, rth=rth,
                ber=ber)


@pytest.fixture(scope="module")
def jax_run():
    J.gv.default()
    out = _chain(J.gv, JD, jook)
    J.gv.default()
    return out


def _grid_step(eye):
    return abs(eye.mu1 - eye.mu0) / 999


def test_readme_chain_matches_jax(jax_run):
    j = jax_run
    t = _chain(T.gv, TD, took)
    np.testing.assert_array_equal(t["tx"].data, j["tx"].data)
    assert t["v"].dtype == torch.float64 and t["pd"].dtype == torch.float64
    assert t["fib"].dtype == torch.complex64
    assert t["fib"].n_steps == 8
    a, b = t["pd"].to_numpy(), j["pd"].to_numpy()
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4
    assert isinstance(t["rx"], T.BinarySequence)
    np.testing.assert_array_equal(t["rx"].data, j["rx"].data)
    assert t["ber"] == j["ber"]
    assert abs(t["rth"] - j["rth"]) <= 2 * _grid_step(j["eye"])
    for k in LEVELS:
        assert getattr(t["eye"], k) == pytest.approx(getattr(j["eye"], k),
                                                     rel=1e-3), k


def test_seeded_chain_is_held_statistically(jax_run):
    """``gv(seed=...)``: the PD noise comes from a torch.Generator.  About
    N_BITS/2 slots a level, the samples of one slot share its noise."""
    t = _chain(T.gv, TD, took, seed=123)
    j = jax_run["eye"]
    assert t["ber"] <= max(10 * jax_run["ber"], 1e-2)
    assert abs(t["rth"] - jax_run["rth"]) <= 0.02 * jax_run["rth"]
    n = N_BITS / 2
    for k, s_k, n_k in (("mu0", "s0", n), ("mu1", "s1", n),
                        ("s0", "s0", 2 * n), ("s1", "s1", 2 * n)):
        tol = 5 * getattr(j, s_k) / np.sqrt(n_k)
        assert abs(getattr(t["eye"], k) - getattr(j, k)) <= tol, k
    # the same seed gives the same run
    again = _chain(T.gv, TD, took, seed=123)
    np.testing.assert_array_equal(again["pd"].to_numpy(),
                                  t["pd"].to_numpy())


def test_jax_signals_carried_into_the_port(jax_run):
    """The JAX chain's own FIBER output, carried across, gives the same PD
    voltage and decisions through the port's receiver.  The photocurrent
    ``E * conj(E)`` of a complex64 field is float32 in both packages and
    rounded differently by torch and NumPy: within 1e-6 of the largest
    sample."""
    gv_from_jax(J.gv.default()(sps=64, R=10e9, N=N_BITS))
    fib = signal_from_jax(jax_run["fib"])
    assert fib.dtype == torch.complex64 and fib.noise is T.NULL
    np.random.seed(0)
    pdo = TD.PD(fib, BW=7.5e9, r=1, include_noise="all")
    a, b = pdo.to_numpy(), jax_run["pd"].to_numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    rx, _, _ = took.DSP(pdo)
    np.testing.assert_array_equal(rx.data, jax_run["rx"].data)
    J.gv.default()


def test_ber_estimator_and_theory(jax_run):
    je = jax_run["eye"]
    te = T.Eye(mu0=je.mu0, mu1=je.mu1, s0=je.s0, s1=je.s1)
    assert took.BER_analizer("estimator", eye_obj=te) == \
        jook.BER_analizer("estimator", eye_obj=je)
    assert took.THRESHOLD_EST(te) == jook.THRESHOLD_EST(je)
    np.testing.assert_array_equal(
        took.theory_BER(np.array([0.5, 1.0]), 0.1, np.array([0.1, 0.2])),
        jook.theory_BER(np.array([0.5, 1.0]), 0.1, np.array([0.1, 0.2])))
    np.testing.assert_allclose(
        T.theory_BER(np.array([-25.0, -20.0]), "ook", ER=20),
        J.theory_BER(np.array([-25.0, -20.0]), "ook", ER=20), rtol=1e-12)
    with pytest.raises(TypeError):
        took.BER_analizer("guess")
    assert took.BER_analizer("counter", Tx="0101", Rx=[0, 1, 1, 1]) == 0.25
    # the shim exposes what the reference's ook module does
    assert set(jook.__all__) <= set(took.__all__)
    assert {"GET_EYE", "LPF", "SAMPLER", "gv", "Q"} <= set(took.__all__)
