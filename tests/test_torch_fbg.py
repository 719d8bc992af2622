"""The port's fiber Bragg grating, held to the JAX package's on the CPU:
the geometry resolver on every branch and error, the plain coupled-mode RK4
(``kernels.fbg_rk4_ref``, what ``kernels.fbg_rk4`` computes on CPU tensors)
against the JAX ``devices._fbg_rk4`` scan, and ``devices.FBG`` end to end.

Tolerance: both packages integrate in complex64 with the same float32
constants and the same order of operations, and neither contracts a
product and a sum on the CPU, so R, S and H agree to 1e-6 of their peak
(measured: bit for bit); the filtered field to 1e-9 of its peak (float64
spectra).  The kernel itself runs on the card only
(tests/test_torch_cuda.py, chip_smoke.py phase 20).
"""
import re

import numpy as np
import pytest
import torch

from opticomlib_tpu import devices as JD, gv as jgv, signals as js
from opticomlib_tpu.utils.analysis import _timer as jtimer
from opticomlib_tpu_torch import devices as TD, gv, signals as ts
from opticomlib_tpu_torch.ops import kernels
from opticomlib_tpu_torch.utils.analysis import _timer

torch.set_num_threads(2)
TOL = 1e-6


@pytest.fixture(autouse=True)
def _gv():
    gv.default()
    gv(sps=64, R=10e9, N=128, device="cpu")
    jgv(sps=64, R=10e9, N=128)
    yield
    gv.default()
    jgv.default()


# ------------------------------------------------------------- geometry
_F0 = 193.4e12
_GEOMETRY = [
    dict(fc=_F0, dneff=1e-4, kL=2.0),
    dict(fc=_F0, dneff=1e-4, N=20000),
    dict(fc=_F0, dneff=1e-4, L=0.01),
    dict(fc=_F0, vdneff=1e-4, kL=2.0),
    dict(fc=_F0, vdneff=1e-4, N=20000),
    dict(fc=_F0, vdneff=1e-4, L=0.01),
    dict(landa_D=1550e-9, dneff=1e-4, kL=2.0),
    dict(landa_D=1550e-9, dneff=1e-4, N=20000),
    dict(landa_D=1550e-9, dneff=1e-4, L=0.01),
    dict(landa_D=1550e-9, vdneff=1e-4, kL=2.0),
    dict(landa_D=1550e-9, vdneff=1e-4, N=20000),
    dict(landa_D=1550e-9, vdneff=1e-4, L=0.01),
    dict(landa_D=1550e-9, kL=2.0, L=0.01),
    dict(landa_D=1550e-9, kL=2.0, N=20000),
]
_GEOMETRY_ERRORS = [
    dict(fc=_F0, dneff=1e-4),
    dict(fc=_F0, vdneff=1e-4),
    dict(fc=_F0, kL=2.0),
    dict(landa_D=1550e-9, dneff=1e-4),
    dict(landa_D=1550e-9, vdneff=1e-4),
    dict(landa_D=1550e-9, kL=2.0),
    dict(landa_D=1550e-9, L=0.01),
    dict(kL=2.0, L=0.01),
]


def _geometry(mod, kw):
    args = dict(neff=1.45, v=0.8, landa_D=None, fc=None, kL=None, L=None,
                N=None, dneff=None, vdneff=None)
    args.update(kw)
    return mod._fbg_resolve_geometry(**args)


@pytest.mark.parametrize("kw", _GEOMETRY,
                         ids=lambda kw: "-".join(sorted(kw)))
def test_resolve_geometry_matches_jax(kw):
    assert _geometry(TD, kw) == _geometry(JD, kw)


@pytest.mark.parametrize("kw", _GEOMETRY_ERRORS,
                         ids=lambda kw: "-".join(sorted(kw)))
def test_resolve_geometry_errors_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        _geometry(JD, kw)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        _geometry(TD, kw)


def test_apodization_choices():
    z = np.linspace(-0.5, 0.5, 101)
    for name in ("rcos", "gaussian", "parabolic"):
        np.testing.assert_array_equal(TD._fbg_apodization(name)(z),
                                      JD._fbg_apodization(name)(z))
    assert TD._fbg_apodization("uniform") is None

    def f(z):
        return z
    assert TD._fbg_apodization(f) is f
    with pytest.warns(UserWarning, match="not recognized"):
        assert TD._fbg_apodization("sinc") is None
    with pytest.raises(ValueError, match="string or a function"):
        TD._fbg_apodization(3)


# ------------------------------------------------------------ RK4 scan
def _coefficients(n=512, kL=2.0, seed=0):
    """delta, s, k of a grating over a detuning sweep (float64)."""
    r = np.random.default_rng(seed)
    delta = np.linspace(-40.0, 40.0, n) + 0.01 * r.normal(size=n)
    s = 0.3 * np.ones(n) + 0.001 * r.normal(size=n)
    k = kL * (1 + 1e-3 * r.normal(size=n))
    return delta, s, k


_APODIZATIONS = ["uniform", "rcos", "gaussian", "parabolic",
                 lambda z: np.cos(np.pi * z) ** 2]


@pytest.mark.parametrize("F", [0.0, 10.0])
@pytest.mark.parametrize("apo", _APODIZATIONS,
                         ids=["uniform", "rcos", "gaussian", "parabolic",
                              "callable"])
def test_fbg_rk4_ref_matches_jax_scan(apo, F):
    delta, s, k = _coefficients()
    n_steps = 600
    apo_func = JD._fbg_apodization(apo)
    Rj, Sj = JD._fbg_rk4(delta, s, k, F, apo_func, n_steps)
    t = [torch.as_tensor(a.astype(np.float32)) for a in (delta, s, k)]
    kernels.reset_launches()
    R, S = kernels.fbg_rk4(*t, F, *TD._fbg_grid(apo_func, n_steps, "cpu"),
                           n_steps)
    assert kernels.LAUNCHES["fbg_rk4"] == 0  # CPU tensors: the plain version
    assert R.dtype == S.dtype == torch.complex64
    for a, b in ((R, Rj), (S, Sj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=TOL * np.abs(b).max())
    np.testing.assert_allclose((S / R).numpy(), Sj / Rj, rtol=0, atol=TOL)


def test_fbg_grid_matches_jax():
    """The step grid: z from 1/2 down by 1/n_steps, float32, and the
    apodization at z, z + dz/2 and z + dz."""
    n = 7
    p0, p1, p2, zs = TD._fbg_grid(TD._fbg_apodization("gaussian"), n, "cpu")
    dz = -1.0 / n
    zh = 0.5 + dz * np.arange(n)
    g = JD._fbg_apodization("gaussian")
    for got, want in ((p0, g(zh)), (p1, g(zh + dz / 2)), (p2, g(zh + dz)),
                      (zs, zh)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    ones = TD._fbg_grid(None, n, "cpu")[:3]
    assert all(torch.equal(p, torch.ones(n)) for p in ones)


def test_fbg_rk4_rejects_bad_arguments():
    t = torch.zeros(4)
    g = torch.zeros(3)
    with pytest.raises(TypeError, match="float32"):
        kernels.fbg_rk4(t.double(), t, t, 0.0, g, g, g, g, 3)
    with pytest.raises(ValueError, match="one length"):
        kernels.fbg_rk4(t, t[:3], t, 0.0, g, g, g, g, 3)
    with pytest.raises(ValueError, match="n_steps"):
        kernels.fbg_rk4(t, t, t, 0.0, g, g, g, g, 4)
    with pytest.raises(ValueError, match="1-D"):
        kernels.fbg_rk4(t.reshape(2, 2), t, t, 0.0, g, g, g, g, 3)


# --------------------------------------------------------------- device
def _field(n=64 * 128, seed=3):
    r = np.random.default_rng(seed)
    return r.normal(size=n) + 1j * r.normal(size=n)


_DESIGNS = [
    dict(vdneff=1e-4, kL=2.0),
    dict(vdneff=1e-4, kL=2.0, filtfilt=False),
    dict(dneff=1e-4, kL=3.0, apodization="rcos"),
    dict(vdneff=1e-4, kL=8.0, apodization="gaussian", F=10.0),
    dict(vdneff=2e-4, N=30000, apodization="parabolic", F=-4.0),
    dict(vdneff=1e-4, kL=2.0, apodization=lambda z: np.cos(np.pi * z)),
]


@pytest.mark.parametrize("kw", _DESIGNS, ids=range(len(_DESIGNS)))
def test_fbg_matches_jax(kw):
    x = _field()
    noise = 0.01 * _field(seed=4)
    to, tH = TD.FBG(ts.OpticalSignal(x, noise), fc=gv.f0, print_params=False,
                    retH=True, **kw)
    jo, jH = JD.FBG(js.OpticalSignal(x, noise), fc=jgv.f0,
                    print_params=False, retH=True, **kw)
    assert isinstance(tH, np.ndarray) and tH.shape == jH.shape
    np.testing.assert_allclose(tH, jH, rtol=0, atol=TOL)
    for a, b in ((to.signal, jo.signal), (to.noise, jo.noise)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-9 * np.abs(b).max())
    assert to.n_pol == 1 and to.execution_time > 0


def test_fbg_two_pol():
    x = np.stack([_field(), 0.5 * _field(seed=5)])
    to = TD.FBG(ts.OpticalSignal(x), fc=gv.f0, vdneff=1e-4, kL=2.0,
                print_params=False)
    jo = JD.FBG(js.OpticalSignal(x), fc=jgv.f0, vdneff=1e-4, kL=2.0,
                print_params=False)
    assert to.n_pol == 2
    np.testing.assert_allclose(to.signal.numpy(), np.asarray(jo.signal),
                               rtol=0, atol=1e-9 * np.abs(x).max())


@pytest.mark.parametrize("kL", [1.0, 2.0, 3.0])
def test_uniform_peak_is_tanh_kL(kL):
    """A uniform grating reflects tanh(kL) of the field at its centre."""
    _, H = TD.FBG(ts.OpticalSignal(np.ones(64 * 128, complex)), fc=gv.f0,
                  vdneff=1e-4, kL=kL, print_params=False, filtfilt=False,
                  retH=True)
    assert abs(np.abs(H).max() - np.tanh(kL)) < 1e-4


def test_printed_design_block(capsys):
    for kw in (dict(vdneff=1e-4, kL=2.0),
               dict(vdneff=1e-4, kL=8.0, apodization="gaussian", F=10.0)):
        TD.FBG(ts.OpticalSignal(_field()), fc=gv.f0, **kw)
        got = capsys.readouterr().out
        JD.FBG(js.OpticalSignal(_field()), fc=jgv.f0, **kw)
        assert got == capsys.readouterr().out
        assert "*** Fiber Bragg Grating Features ***" in got
        assert (" - F = 10.0" in got) == ("F" in kw)


def test_fbg_warnings_and_type_check():
    # a grating wider than the band: |H| > 0.5 everywhere
    with pytest.warns(UserWarning, match="Bandwidth of the grating"):
        TD.FBG(ts.OpticalSignal(_field(256)), fc=gv.f0, vdneff=5e-2,
               kL=20.0, print_params=False)
    with pytest.raises(TypeError, match="optical_signal"):
        TD.FBG(ts.ElectricalSignal(_field(256)), fc=gv.f0, vdneff=1e-4,
               kL=2.0)


def test_fbg_timer_balance():
    depth0 = len(_timer._stack)
    jdepth0 = len(jtimer._stack)
    out, H = TD.FBG(ts.OpticalSignal(_field(4096)), fc=gv.f0, vdneff=1e-4,
                    kL=2.0, print_params=False, retH=True)
    assert len(_timer._stack) == depth0
    assert out.execution_time > 0
    assert H.shape == (4096,)
    assert len(jtimer._stack) == jdepth0


@pytest.mark.parametrize("kind", ["walk", "levels", "sinc", "noise",
                                  "noisy_tail"])
def test_peak_widths_equal_scipy(kind):
    """The bandwidth's peak widths equal ``scipy.signal.peak_widths``
    exactly: random walks, integer plateaus, a sinc with noise, white noise,
    and a falling tail whose noise makes a local maximum of every few
    samples (what |H| looks like at 2^24 bins)."""
    import scipy.signal as sg
    rng = np.random.default_rng(["walk", "levels", "sinc", "noise",
                                 "noisy_tail"].index(kind))
    for _ in range(50):
        n = int(rng.integers(3, 3000))
        f = np.linspace(-1, 1, n)
        y = {"walk": lambda: rng.normal(size=n).cumsum(),
             "levels": lambda: rng.integers(0, 5, n).astype(float),
             "sinc": lambda: np.abs(np.sinc(8 * f)) + 1e-3 * rng.normal(
                 size=n),
             "noise": lambda: rng.normal(size=n),
             "noisy_tail": lambda: (1 / (1 + (40 * f) ** 2)) * (
                 1 + 1e-4 * rng.normal(size=n))}[kind]().astype(np.float32)
        peaks, _ = sg.find_peaks(y)
        if peaks.size:
            np.testing.assert_array_equal(TD._peak_widths(y, peaks),
                                          sg.peak_widths(y, peaks)[0])
