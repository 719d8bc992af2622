"""The port's utility layer (``utils.analysis``) and ``HierLogger``, case for
case as tests/test_utils.py checks the JAX package's, each function run
through both packages on the same NumPy inputs.  The functions are host
NumPy in both, so results are held equal (``assert_array_equal``), and
where a port function also takes a tensor the tensor's result is held
equal to the array's.  The analytic oracles of tests/test_utils.py are
kept beside the comparison.
"""
import logging

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from opticomlib_tpu.utils import analysis as JA  # noqa: E402
from opticomlib_tpu_torch.utils import analysis as TA  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _both(name, *args, **kw):
    return getattr(TA, name)(*args, **kw), getattr(JA, name)(*args, **kw)


def _equal(t, j):
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(t) == len(j)
        for a, b in zip(t, j):
            _equal(a, b)
        return
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert np.asarray(t).dtype == np.asarray(j).dtype


def test_is_numeric():
    for x in (1, 2.5, 1 + 2j, np.float32(3), np.int64(2)):
        assert TA._is_numeric(x) and JA._is_numeric(x)
    for x in (True, "1", [1], None):
        assert not TA._is_numeric(x) and not JA._is_numeric(x)


def test_Q_and_gaus():
    x = np.linspace(-10, 10, 10001)
    _equal(*_both("gaus", x, 0.3, 1.7))
    _equal(*_both("Q", x))
    t, _ = _both("gaus", x, 0, 1)
    assert np.isclose(np.trapezoid(t, x), 1.0, atol=1e-6)
    np.testing.assert_array_equal(TA.gaus(torch.as_tensor(x)), t)


def _response(n=512, fs=4e9):
    f = np.fft.fftshift(np.fft.fftfreq(n, d=1 / fs))
    return 1.0 / (1 + 1j * f / 1e9) * np.exp(-1j * 2e-10 * f)


def test_phase_tau_g_dispersion():
    H = _response()
    _equal(*_both("phase", H))
    _equal(*_both("phase", H, 17))
    _equal(*_both("tau_g", H, 4e9))
    _equal(*_both("dispersion", H, 4e9, 193.4e12))
    np.testing.assert_array_equal(TA.tau_g(torch.as_tensor(H), 4e9),
                                  JA.tau_g(H, 4e9))
    for name, args in (("phase", ()), ("tau_g", (4e9,)),
                       ("dispersion", (4e9, 193.4e12))):
        for mod in (TA, JA):
            with pytest.raises(TypeError):
                getattr(mod, name)(3.0, *args)


@pytest.mark.parametrize("alpha", [0.0, 0.25, 1.0])
def test_rcos(alpha):
    x = np.linspace(-1.5, 1.5, 1001)
    _equal(*_both("rcos", x, alpha, 2.0))


def test_norm_nearest():
    _equal(*_both("norm", [1, 2, 4]))
    np.testing.assert_allclose(TA.norm([1, 2, 4]), [0.25, 0.5, 1.0])
    x = np.array([1.0, 2.0, 3.0])
    for name in ("nearest", "nearest_index"):
        _equal(*_both(name, x, 2.2))
        _equal(*_both(name, x, [0.9, 3.3]))
    assert TA.nearest(x, 2.2) == 2.0 and TA.nearest_index(x, 2.2) == 1
    np.testing.assert_array_equal(TA.nearest_index(x, [0.9, 3.3]), [0, 2])
    assert TA.nearest(torch.as_tensor(x), 2.2) == 2.0
    np.testing.assert_array_equal(
        TA.nearest_index(torch.as_tensor(x), torch.tensor([0.9, 3.3])),
        [0, 2])


def test_get_time():
    assert TA.get_time(lambda: sum(range(100)), n=3) > 0


def test_phase_estimator():
    t = np.linspace(0, 1e-6, 2000)
    f = 5e6
    rng = np.random.default_rng(3)
    x = 1.8 * np.cos(2 * np.pi * f * t + 0.7) + rng.normal(0, 0.05, t.size)
    (phi, amp), ref = _both("phase_estimator", t, x, f)
    assert (phi, amp) == ref
    assert np.isclose(phi, 0.7, atol=0.01)
    assert np.isclose(amp, 1.8, atol=0.02)
    assert TA.phase_estimator(torch.as_tensor(t), torch.as_tensor(x),
                              f) == ref
    with pytest.raises(ValueError):
        TA.phase_estimator(t[:-1], x, f)


def test_get_psd_sinusoid():
    fs = 100e9
    f0 = 200 * fs / 2048  # exactly on a Welch bin -> no scalloping loss
    t = np.arange(4096) / fs
    x = 2.0 * np.cos(2 * np.pi * f0 * t)
    (f, p), ref = _both("get_psd", x, fs=fs, nperseg=2048)
    _equal((f, p), ref)
    ipk = np.argmax(p[f > 0]) + np.sum(f <= 0)
    assert abs(f[ipk] - f0) < fs / 2048 * 2
    assert np.isclose(p[ipk], 1.0, rtol=0.05)  # (A/2)^2 = 1
    # a tensor and a signal-like object with a .signal tensor
    _equal(TA.get_psd(torch.as_tensor(x), fs=fs, nperseg=2048), ref)

    class _Sig:
        signal = torch.as_tensor(x)
    _equal(TA.get_psd(_Sig(), fs=fs, nperseg=2048), ref)
    with pytest.raises(TypeError):
        TA.get_psd(3.0, fs=fs)


def test_apply_optimized_gaussian_filter():
    fs = 16e9
    T_bit = 1e-9
    t = np.arange(1600) / fs
    bits = np.tile([0.0, 1, 1, 0, 1, 0, 0, 1, 0, 1], 10)
    x = np.repeat(bits, 16)
    y, ref = _both("apply_optimized_gaussian_filter", t, x, T_bit)
    _equal(y, ref)
    assert np.isclose(np.max(np.abs(y)), 1.0, rtol=1e-6)
    assert np.max(np.abs(np.diff(y))) < np.max(np.abs(np.diff(x)))
    np.testing.assert_array_equal(TA.apply_optimized_gaussian_filter(
        torch.as_tensor(t), torch.as_tensor(x), T_bit), ref)
    with pytest.raises(ValueError):
        TA.apply_optimized_gaussian_filter(t[::-1], x, T_bit)


@pytest.mark.parametrize("f0", [None, 193.4e12])
def test_bode_plot(f0):
    H = _response()
    fig, axs = TA.bode(H, 4e9, f0=f0, show=False, ret=True)
    jfig, jaxs = JA.bode(H, 4e9, f0=f0, show=False, ret=True)
    assert len(axs) == len(jaxs) == (4 if f0 else 3)
    for a, b in zip(axs, jaxs):
        la, lb = a.get_lines()[0], b.get_lines()[0]
        np.testing.assert_array_equal(la.get_xdata(), lb.get_xdata())
        np.testing.assert_array_equal(la.get_ydata(), lb.get_ydata())
    assert TA.bode(torch.as_tensor(H), 4e9, show=False) is None


def test_hier_logger(capsys):
    from opticomlib_tpu_torch import HierLogger, hlog
    from opticomlib_tpu_torch.logger import HierLogger as HL
    assert HierLogger is HL and isinstance(hlog, HierLogger)

    def tree(cls, name):
        hl = cls(name)
        hl.logger.handlers.clear()
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        hl.logger.addHandler(handler)
        hl.logger.propagate = False
        hl.setLevel(logging.DEBUG)

        @hl.auto_indent
        def inner():
            hl.debug("inner body")
            hl.info("info")
            hl.warning("warn")

        @hl.auto_indent
        def outer():
            inner()
            with hl.indent():
                hl.error("deeper")
            hl.critical("back")

        @hl.auto_indent_methods
        class Box:
            def f(self):
                hl.debug("f body")

            @property
            def p(self):
                hl.debug("p body")
                return 1

            @staticmethod
            def s():
                hl.debug("s body")

            @classmethod
            def k(cls):
                hl.debug("k body")

        outer()
        b = Box()
        b.f()
        assert b.p == 1
        Box.s()
        Box.k()
        return capsys.readouterr().err

    from opticomlib_tpu.logger import HierLogger as JHL
    got = tree(HierLogger, "test_hier_torch")
    assert got == tree(JHL, "test_hier_jax")
    lines = [ln for ln in got.splitlines() if ln]
    # top-level call flush left, nested call one level in
    assert lines[0].startswith("/> ")
    assert any(ln.startswith("|   /> inner") for ln in lines)
    assert any(ln.startswith("|   |   /> inner body") for ln in lines)
    assert any(ln.startswith("|   |   /> deeper") for ln in lines)
