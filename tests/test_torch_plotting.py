"""The port's drawing, case for case as tests/test_plotting.py checks the
JAX package's (Agg backend, no display), and the drawn data held to the JAX
package's on the same inputs: the signal plots' lines, the eye density
image (its counts come from ``eye_density``, the histogram2d kernel's
plain version here) and the per-trace eye.

Tolerance: the lines are the same float64 host data, held equal; the
smoothed density of the same counts to 1e-12 relative (the port smooths
float32 counts converted to float64, exactly the integers JAX counts).
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402

from opticomlib_tpu import eyediag as jeyediag, gv as jgv  # noqa: E402
from opticomlib_tpu import devices as JD, signals as js  # noqa: E402
from opticomlib_tpu_torch import gv  # noqa: E402
from opticomlib_tpu_torch.devices import DAC, GET_EYE, PRBS  # noqa: E402
from opticomlib_tpu_torch.eyediag import (Eye, EyeShowOptions,  # noqa: E402
                                          eyediagram, eyediagram_density)
from opticomlib_tpu_torch.signals import (BinarySequence,  # noqa: E402
                                          ElectricalSignal, OpticalSignal)
from opticomlib_tpu_torch.utils.analysis import bode  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _close_figs():
    gv.default()
    gv.device = "cpu"
    yield
    plt.close("all")
    gv.default()
    jgv.default()


def _gv(**kw):
    gv(device="cpu", **kw)
    jgv(**kw)


def _noisy_nrz(n_bits=256, sps=16, mod=None):
    _gv(sps=sps, R=1e9, N=n_bits)
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, n_bits)
    if mod is js:
        sig = JD.DAC(js.BinarySequence(bits), Vpp=1.0)
        cls = js.ElectricalSignal
    else:
        sig = DAC(BinarySequence(bits), Vpp=1.0)
        cls = ElectricalSignal
    return sig + cls(np.zeros(sig.size),
                     noise=0.05 * rng.normal(size=sig.size))


def _lines(ax):
    return [(ln.get_xdata(), ln.get_ydata()) for ln in ax.get_lines()]


def test_binary_sequence_plot():
    BinarySequence("1 0 1 1 0").plot()
    got = _lines(plt.gca())
    plt.close("all")
    js.BinarySequence("1 0 1 1 0").plot()
    for (x, y), (jx, jy) in zip(got, _lines(plt.gca())):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_electrical_signal_plot_and_psd():
    sig = _noisy_nrz()
    sig.plot("-", n=500, xlabel="t", ylabel="V", grid=True)
    sig.psd("-", kind="linear")
    sig.psd("-", kind="log")
    got = _lines(plt.gca())
    plt.close("all")
    jsig = _noisy_nrz(mod=js)
    jsig.plot("-", n=500, xlabel="t", ylabel="V", grid=True)
    jsig.psd("-", kind="linear")
    jsig.psd("-", kind="log")
    want = _lines(plt.gca())
    assert len(got) == len(want) == 3
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_allclose(x, jx, rtol=1e-12)
        np.testing.assert_allclose(y, jy, rtol=1e-9, atol=1e-15)


def test_electrical_signal_plot_eye():
    sig = _noisy_nrz()
    e = sig.plot_eye()
    assert isinstance(e, Eye) and isinstance(e.mu1, float)


def test_optical_signal_plot_both_pols():
    _gv(sps=8, R=1e9, N=64)
    x = np.exp(1j * np.linspace(0, 4 * np.pi, 512)).astype(np.complex64)
    osig = OpticalSignal(np.stack([x, 0.5 * x]), n_pol=2)
    osig.plot("-").grid().legend(["x", "y"])
    lines = plt.gca().get_lines()
    assert len(lines) == 2
    np.testing.assert_allclose(lines[1].get_ydata(), 0.5 * x.real)


def test_eye_object_plot_and_print(capsys):
    sig = _noisy_nrz()
    eye_obj = GET_EYE(sig, nslots=128)
    eye_obj.print("smoke")
    assert "eye diagram parameters" in capsys.readouterr().out
    assert eye_obj.plot() is eye_obj


@pytest.mark.parametrize("style", ["density", "line", "dot"])
def test_eyediagram_styles(style):
    sig = _noisy_nrz()
    y = np.real(sig.signal.numpy())
    ax = eyediagram(y, sps=gv.sps, style=style)
    jax_ax = jeyediag.eyediagram(y, sps=jgv.sps, style=style)
    if style == "density":
        img, jimg = ax.get_images()[0], jax_ax.get_images()[0]
        np.testing.assert_allclose(img.get_array(), jimg.get_array(),
                                   rtol=1e-12, atol=1e-12)
        assert img.get_extent() == pytest.approx(jimg.get_extent())
    else:
        assert len(ax.get_lines()) == len(jax_ax.get_lines())
    # a tensor waveform draws the same
    ax2 = eyediagram(torch.as_tensor(y), sps=gv.sps, style=style)
    assert len(ax2.get_lines()) == len(ax.get_lines())


def test_eyediagram_density_counts_match_jax():
    rng = np.random.default_rng(8)
    t = np.tile(np.linspace(-1, 1, 64), 50)
    y = np.sin(3 * t) + 0.1 * rng.normal(size=t.size)
    y[5] = np.nan  # dropped by both
    ax = eyediagram_density(t, y, nbins=64, sigma=1.5)
    jax_ax = jeyediag.eyediagram_density(t, y, nbins=64, sigma=1.5)
    np.testing.assert_allclose(ax.get_images()[0].get_array(),
                               jax_ax.get_images()[0].get_array(),
                               rtol=1e-12, atol=1e-12)


def test_bode_plot():
    _gv(sps=16, R=1e9, N=64)
    fs = 4e9
    f = np.fft.fftfreq(512, d=1 / fs)
    H = 1.0 / (1 + 1j * f / 1e9)
    bode(H, fs, f0=193.4e12, show=False)
    assert len(plt.gcf().axes) == 4


def test_prbs_then_plot_chain():
    _gv(sps=8, R=1e9, N=127)
    seq = PRBS(order=7)
    DAC(seq, Vpp=1.0).plot()
    assert plt.gca().get_lines()[0].get_ydata().size == 127 * 8


def test_eye_plot_annotated_options(tmp_path):
    _gv(sps=16, R=1e9, N=256)
    sig = DAC(PRBS(order=7, len=256), Vpp=1.0, pulse_shape="gaussian")
    eye_obj = GET_EYE(sig, nslots=256)

    opts = EyeShowOptions(all_none=True)
    assert opts.averages and opts.histogram and opts.cross_points
    assert not EyeShowOptions().threshold
    out = tmp_path / "eye.png"
    eye_obj.plot(show_options=opts, hlines=[0.5], vlines=[0.0],
                 style="light", smooth=True, title="t", savefig=str(out))
    assert out.exists() and out.stat().st_size > 0
    plt.close("all")

    # non-smooth per-trace rendering + external ax
    fig, ax = plt.subplots()
    eye_obj.plot(show_options=EyeShowOptions(t_opt=True), smooth=False,
                 ax=ax)
    plt.close("all")

    # bad style rejected; empty object rejected
    with pytest.raises(TypeError):
        eye_obj.plot(style="neon")
    with pytest.raises(ValueError):
        Eye({}).plot()


def test_eye_plot_trace_window_uses_resampled_sps():
    _gv(sps=16, R=10e9, N=256)
    v = DAC(PRBS(order=9, len=256), Vpp=1, pulse_shape="gaussian")
    e = GET_EYE(v, nslots=128, sps_resamp=64)
    fig, ax = plt.subplots()
    e.plot(smooth=False, ax=ax)
    lcs = [c for c in ax.collections if isinstance(c, LineCollection)]
    assert lcs, "per-trace path must add a LineCollection"
    segs = np.concatenate([np.asarray(c.get_segments()) for c in lcs])
    xs = segs[..., 0]
    assert xs.min() <= -0.9 and xs.max() >= 0.9, (xs.min(), xs.max())
    plt.close(fig)


def test_partial_eye_plot_tolerates_missing_fields():
    sps = 16
    rng = np.random.default_rng(1)
    y = np.repeat(rng.integers(0, 2, 64), sps) + 0.0
    t = np.kron(np.ones(32), np.linspace(-1, 1 - 1 / sps, 2 * sps))

    # only mu0 set; mu1/s0/s1/t_span absent -> None via __getattr__
    partial = Eye({"y": y, "t": t, "sps": sps, "mu0": 0.1, "t_opt": 0.0})
    partial.plot()
    plt.close("all")

    # crossing amplitude exactly 0.0 must still draw the cross markers
    full = Eye({"y": y, "t": t, "sps": sps, "t_opt": 0.0, "t_left": -0.5,
                "t_right": 0.5, "y_left": 0.0, "y_right": 0.0,
                "threshold": 0.5, "mu0": 0.0, "mu1": 1.0,
                "s0": 0.05, "s1": 0.05})
    fig, ax = plt.subplots()
    full.plot(show_options=EyeShowOptions(cross_points=True), ax=ax)
    assert any(ln.get_marker() == "x" for ln in ax.get_lines())


@pytest.mark.parametrize("smooth", [True, False])
def test_eye_plot_matches_jax(smooth):
    """The same traces draw the same density image (or line colours) and
    the same histogram panel in both packages."""
    sps = 16
    rng = np.random.default_rng(4)
    y = np.repeat(rng.integers(0, 2, 128), sps) + 0.05 * rng.normal(
        size=128 * sps)
    t = np.kron(np.ones(64), np.linspace(-1, 1 - 1 / sps, 2 * sps))
    d = {"y": y, "t": t, "sps": sps, "t_opt": 0.0, "t_dist": 1.0,
         "mu0": 0.0, "mu1": 1.0, "s0": 0.05, "s1": 0.05, "threshold": 0.5}
    opts = dict(show_options=EyeShowOptions(histogram=True), smooth=smooth)
    Eye(d).plot(**opts)
    fig = plt.gcf()
    jeyediag.Eye(d).plot(**opts)
    jfig = plt.gcf()
    ax0, hist = fig.axes
    jax0, jhist = jfig.axes
    if smooth:
        np.testing.assert_allclose(ax0.get_images()[0].get_array(),
                                   jax0.get_images()[0].get_array(),
                                   rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(ax0.collections[0].get_colors(),
                                   jax0.collections[0].get_colors(),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(hist.get_lines()[-1].get_xdata(),
                               jhist.get_lines()[-1].get_xdata(),
                               rtol=1e-12, atol=1e-12)
