"""The fiber's trajectory and progress bar on the port, held to the JAX
package on the CPU: ``FIBER(return_steps=True)`` /
``ssfm_propagate(return_steps=True)`` (tests/test_ops.py
test_ssfm_return_steps_trajectory), ``show_progress``
(tests/test_round2_fixes.py TestShowProgress), the timer balance of the
early returns (TestTimerStackBalance), ``dispersive_step`` and the two
fiber animations.

Tolerances: the step counts are equal and fixed-step and single-step
grids equal to the last bit; an adaptive grid follows max|A|^2 of frames
that differ by FFT rounding, so its z agree to 1e-5 of the span (measured:
4e-7); frames agree to 1e-5 of their peak (measured: 7e-7); the progress
bar changes no bit.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.animation import FuncAnimation  # noqa: E402

from opticomlib_tpu import devices as JD, gv as jgv, signals as js  # noqa: E402
from opticomlib_tpu.ops import ssfm as jssfm  # noqa: E402
from opticomlib_tpu_torch import devices as TD, gv, signals as ts  # noqa: E402
from opticomlib_tpu_torch.ops import ssfm  # noqa: E402
from opticomlib_tpu_torch.utils.analysis import _timer  # noqa: E402

torch.set_num_threads(2)
FRAME_TOL = 1e-5
Z_TOL = 1e-5


@pytest.fixture(autouse=True)
def _gv():
    gv.default()
    gv(sps=16, R=10e9, N=128, device="cpu")
    jgv(sps=16, R=10e9, N=128)
    yield
    plt.close("all")
    gv.default()
    jgv.default()


def _pulse(n=2048, pol=1):
    t = np.arange(n)
    x = 0.15 * np.exp(-((t - n // 2) / 80.0) ** 2) + 0j
    return x if pol == 1 else np.stack([x, 0.5 * x])


_CASES = {
    "adaptive": dict(length=20, alpha=0.2, beta_2=-21, gamma=1.3,
                     phi_max=0.05),
    "fixed_h": dict(length=10, alpha=0.2, beta_2=-21, gamma=1.3, h=3.0),
    "linear_gamma0": dict(length=10, alpha=0.2, beta_2=-21, gamma=0.0),
    "linear_no_dispersion": dict(length=5, alpha=0.2, beta_2=0, gamma=1.3),
}


@pytest.mark.parametrize("pol", [1, 2])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_fiber_return_steps_matches_jax(case, pol):
    kw = _CASES[case]
    x = _pulse(pol=pol)
    jz, jA = JD.FIBER(js.OpticalSignal(x), return_steps=True, **kw)
    z, A = TD.FIBER(ts.OpticalSignal(x), return_steps=True, **kw)
    assert isinstance(z, np.ndarray) and z.dtype == np.float64
    assert z.shape == jz.shape
    if case == "adaptive":
        np.testing.assert_allclose(z, jz, rtol=0, atol=Z_TOL * kw["length"])
    else:
        np.testing.assert_array_equal(z, jz)
    assert z[0] == 0.0 and z[-1] == pytest.approx(kw["length"])
    assert A.dtype == torch.complex64 and A.device.type == "cpu"
    assert tuple(A.shape) == jA.shape == (z.size,) + x.shape
    np.testing.assert_allclose(A.numpy(), jA, rtol=0,
                               atol=FRAME_TOL * np.abs(jA).max())
    np.testing.assert_array_equal(A[0].numpy(), x.astype(np.complex64))


def test_ssfm_return_steps_trajectory():
    n, fs = 1024, 16e9
    A = 0.1 * np.ones(n, dtype=np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n, 1 / fs)
    z, A_z = ssfm.ssfm_propagate(torch.as_tensor(A), w, length=10, alpha=0.2,
                                 beta_2=-20, gamma=1.0, h=2.5,
                                 return_steps=True)
    jz, jA = jssfm.ssfm_propagate(A, w, length=10, alpha=0.2, beta_2=-20,
                                  gamma=1.0, h=2.5, return_steps=True)
    assert z[0] == 0 and np.isclose(z[-1], 10)
    assert A_z.shape[0] == z.size and A_z.shape[1] == n
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_allclose(A_z.numpy(), jA, rtol=0,
                               atol=FRAME_TOL * np.abs(jA).max())


def test_return_steps_needs_the_reference_scheme():
    x = ts.OpticalSignal(_pulse())
    depth0 = len(_timer._stack)
    for method in ("o4", "local_error"):
        with pytest.raises(ValueError, match="only available with"):
            TD.FIBER(x, 1.0, beta_2=-21, gamma=1.3, h=0.5, method=method,
                     return_steps=True)
    with pytest.raises(ValueError, match="mesh= does not support"):
        TD.FIBER(x, 1.0, mesh=object(), return_steps=True)
    assert len(_timer._stack) == depth0


# ----------------------------------------------------------- progress bar
def test_fiber_show_progress_runs(capsys):
    depth0 = len(_timer._stack)
    out = TD.FIBER(ts.OpticalSignal(_pulse(1024)), 2.0, alpha=0.2,
                   beta_2=-21.0, gamma=1.3, h=0.5, show_progress=True)
    assert out.size == 1024
    assert len(_timer._stack) == depth0
    assert "100.0/100.0%" in capsys.readouterr().err
    assert ssfm._progress_handler is None


@pytest.mark.parametrize("kw", [dict(h=0.5), dict(phi_max=0.01)],
                         ids=["fixed_h", "adaptive"])
def test_progress_matches_silent(kw):
    x = _pulse(1024)
    a = TD.FIBER(ts.OpticalSignal(x), 2.0, beta_2=-21.0, gamma=1.3, **kw)
    b = TD.FIBER(ts.OpticalSignal(x), 2.0, beta_2=-21.0, gamma=1.3,
                 show_progress=True, **kw)
    assert torch.equal(a.signal, b.signal) and a.n_steps == b.n_steps


@pytest.mark.parametrize("kw", [dict(h=0.3), dict(phi_max=0.01)],
                         ids=["fixed_h", "adaptive"])
def test_progress_ticks_once_a_step(monkeypatch, kw):
    """The handler sees z after each step, ending at the span: JAX's ticks
    (``jax.debug.callback`` per step, with ``progress=True``) on the same
    grid.  The port's loops tick whenever a handler is installed."""
    seen = {"t": [], "j": []}
    monkeypatch.setattr(ssfm, "_progress_handler",
                        lambda z, L: seen["t"].append((z, L)))
    monkeypatch.setattr(jssfm, "_progress_handler",
                        lambda z, L: seen["j"].append((z, L)))
    x = _pulse(1024)
    w = 2 * np.pi * np.fft.fftfreq(1024, gv.dt)
    _, steps = ssfm.ssfm_propagate(torch.as_tensor(x), w, 2.0,
                                   beta_2=-21.0, gamma=1.3, **kw)
    jssfm.ssfm_propagate(x, w, 2.0, beta_2=-21.0, gamma=1.3, progress=True,
                         **kw)
    jax_ticks = seen["j"]
    assert len(seen["t"]) == steps == len(jax_ticks)
    np.testing.assert_allclose(np.array(seen["t"]), np.array(jax_ticks),
                               rtol=1e-6)
    assert seen["t"][-1][0] == pytest.approx(2.0)


# ----------------------------------------------------------- timer stack
def test_dm_reth():
    depth0 = len(_timer._stack)
    out, H = TD.DM(ts.OpticalSignal(_pulse(1024)), 100, retH=True)
    assert len(_timer._stack) == depth0
    assert out.execution_time > 0
    assert H.shape == (1024,)


def test_fiber_return_steps_timer():
    depth0 = len(_timer._stack)
    z, A_z = TD.FIBER(ts.OpticalSignal(_pulse(1024)), 2.0, alpha=0.2,
                      beta_2=-21.0, gamma=1.3, h=0.5, return_steps=True)
    assert len(_timer._stack) == depth0
    assert z[0] == 0.0 and z[-1] == pytest.approx(2.0)


def test_lpf_reth():
    depth0 = len(_timer._stack)
    out, H = TD.LPF(ts.ElectricalSignal(np.random.default_rng(0).normal(
        size=1024)), 5e9, retH=True)
    assert len(_timer._stack) == depth0
    assert out.execution_time > 0


def test_fbg_reth():
    depth0 = len(_timer._stack)
    gv(sps=32, R=10e9, N=128, device="cpu")
    out, H = TD.FBG(ts.OpticalSignal(_pulse(4096)), fc=gv.f0, vdneff=1e-4,
                    kL=2.0, print_params=False, retH=True)
    assert len(_timer._stack) == depth0
    assert out.execution_time > 0
    assert H.shape == (4096,)


# -------------------------------------------------------------- linear step
@pytest.mark.parametrize("pol", [1, 2])
def test_dispersive_step_matches_jax(pol):
    n = 1024
    x = _pulse(n, pol)
    w = 2 * np.pi * np.fft.fftfreq(n, gv.dt)
    D = ssfm.linear_operator(w, 0.2, -21.0, 0.1)
    np.testing.assert_array_equal(D, jssfm.linear_operator(w, 0.2, -21.0,
                                                           0.1))
    got = ssfm.dispersive_step(torch.as_tensor(x.astype(np.complex64)), D,
                               2.5)
    want = np.asarray(jssfm.dispersive_step(x.astype(np.complex64), D, 2.5))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FRAME_TOL * np.abs(want).max())
    # a tensor operator gives the same
    assert torch.equal(got, ssfm.dispersive_step(
        torch.as_tensor(x.astype(np.complex64)), torch.as_tensor(D), 2.5))


# ------------------------------------------------------------- animations
@pytest.mark.parametrize("pol", [1, 2])
def test_animated_fiber_propagation(pol):
    x = _pulse(2048, pol)
    anim = TD.animated_fiber_propagation(ts.OpticalSignal(x), M=4, length=10,
                                         alpha=0.2, beta_2=-21, gamma=1.3,
                                         h=2.5, show=False)
    janim = JD.animated_fiber_propagation(js.OpticalSignal(x), M=4,
                                          length=10, alpha=0.2, beta_2=-21,
                                          gamma=1.3, h=2.5, show=False)
    assert isinstance(anim, FuncAnimation)
    (line,), (jline,) = anim._fig.axes[0].lines, janim._fig.axes[0].lines
    anim._func(3)
    janim._func(3)
    np.testing.assert_allclose(line.get_ydata(), jline.get_ydata(), rtol=0,
                               atol=FRAME_TOL * np.abs(x).max())
    assert anim._fig.axes[0].get_title() == janim._fig.axes[0].get_title()


@pytest.mark.parametrize("pol", [1, 2])
def test_animated_fiber_propagation_with_phase(pol):
    x = _pulse(2048, pol)
    kw = dict(length=10, alpha=0.2, beta_2=-21, gamma=1.3, show=False)
    anim = TD.animated_fiber_propagation_with_phase(ts.OpticalSignal(x), **kw)
    janim = JD.animated_fiber_propagation_with_phase(js.OpticalSignal(x),
                                                     **kw)
    assert isinstance(anim, FuncAnimation)
    assert len(anim._fig.axes) == 3
    anim._func(1)
    janim._func(1)
    mag, jmag = (a._fig.axes[0].lines[0].get_ydata() for a in (anim, janim))
    np.testing.assert_allclose(mag, jmag, rtol=0,
                               atol=FRAME_TOL * np.abs(jmag).max())
