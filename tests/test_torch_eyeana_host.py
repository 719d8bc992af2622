"""The port's host eye engine (``ops.eyeana.kmeans2_1d``, ``kmeans2_2d``,
``kde_min_threshold``, ``eye_metrics_host``; ``GET_EYE(engine="host")``)
held to the JAX package's NumPy engine, and to the port's tensor engine as
tests/test_eye_device.py holds the JAX device engine to its host one.

Tolerances: the two host engines run the same NumPy code on the same
float64 samples, so they agree exactly; with ``sps_resamp`` the resampling
FFT is torch's in the port and NumPy's in JAX, which round differently,
and values agree to 1e-9 relative.  The tensor engine (float32) is held to
the host one to 2e-4 relative, as in tests/test_eye_device.py.
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu import devices as JD, gv as jgv, signals as js
from opticomlib_tpu.ops import eyeana as jeyeana
from opticomlib_tpu_torch import devices as TD, gv, signals as ts
from opticomlib_tpu_torch.ops import eyeana

torch.set_num_threads(2)
SPS, R, NBITS = 16, 10e9, 2**10

SCALARS = ("mu0", "mu1", "s0", "s1", "t_left", "t_right", "t_opt",
           "t_dist", "t_span0", "t_span1", "y_left", "y_right", "threshold",
           "threshold_plateau", "er", "eye_h", "i", "sps")
TRACES = ("t", "y", "y_top", "y_bot", "y_25_75", "top_int", "bot_int")


@pytest.fixture(autouse=True)
def _reset():
    gv.default()
    gv(sps=SPS, R=R, N=NBITS, device="cpu")
    jgv(sps=SPS, R=R, N=NBITS)
    yield
    gv.default()
    jgv.default()


def _ook_waveform(seed=7, noise=0.05, nbits=NBITS):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nbits)
    x = np.asarray(JD.DAC(bits, Vpp=1, pulse_shape="gaussian").to_numpy()
                   ).real + 0.5
    if noise:
        x = x + rng.normal(0, noise, x.size)
    return x


def _same(got, want, rel=0.0):
    if want is None:
        assert got is None
    elif isinstance(want, (float, int, np.floating)) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(want, rel=rel, abs=0)


def test_kmeans_1d_matches_jax():
    for noise in (0.02, 0.08, 0.2):
        y = _ook_waveform(noise=noise)
        assert eyeana.kmeans2_1d(y) == jeyeana.kmeans2_1d(y)
        assert eyeana.kmeans2_1d(torch.as_tensor(y)) == jeyeana.kmeans2_1d(y)
    flat = np.ones(64)
    assert eyeana.kmeans2_1d(flat) == jeyeana.kmeans2_1d(flat)


def test_kmeans_2d_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal([-0.5, 0.5], 0.05, (300, 2)),
                          rng.normal([0.5, 0.5], 0.05, (200, 2))])
    init = np.array([[-1.0, 0.5], [1.0, 0.5]])
    got = eyeana.kmeans2_2d(pts, init)
    np.testing.assert_array_equal(got, jeyeana.kmeans2_2d(pts, init))
    np.testing.assert_array_equal(
        eyeana.kmeans2_2d(torch.as_tensor(pts), torch.as_tensor(init)), got)


def test_kde_threshold_matches_jax():
    rng = np.random.default_rng(11)
    y = np.concatenate([rng.normal(0, 0.05, 4000),
                        rng.normal(1, 0.08, 4000)]).astype(np.float32)
    assert eyeana.kde_min_threshold(y, 0.0, 1.0) == \
        jeyeana.kde_min_threshold(y, 0.0, 1.0)
    assert eyeana.kde_min_threshold(y, 0.0, 1.0, return_plateau=True) == \
        jeyeana.kde_min_threshold(y, 0.0, 1.0, return_plateau=True)
    assert eyeana.kde_min_threshold(torch.as_tensor(y), 0.0, 1.0) == \
        jeyeana.kde_min_threshold(y, 0.0, 1.0)
    # degenerate: levels equal, or not finite, or too few samples
    for args in ((y, 0.5, 0.5), (y, np.nan, 1.0), (y[:1], 0.0, 1.0)):
        assert eyeana.kde_min_threshold(*args) is None
        assert eyeana.kde_min_threshold(*args, return_plateau=True) == \
            (None, None)


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.15])
@pytest.mark.parametrize("sps_resamp", [None, 64])
def test_eye_metrics_host_matches_jax(sps_resamp, noise):
    x = _ook_waveform(noise=noise)
    h = eyeana.eye_metrics_host(x, sps=SPS, nslots=512,
                                sps_resamp=sps_resamp)
    j = jeyeana.eye_metrics(x, sps=SPS, nslots=512, sps_resamp=sps_resamp)
    assert set(h) == set(j)
    rel = 1e-9 if sps_resamp else 0.0
    for k in SCALARS:
        _same(h[k], j[k], rel)
    for k in TRACES:
        if k in j:
            np.testing.assert_allclose(h[k], j[k], rtol=rel, atol=0,
                                       err_msg=k)


def test_eye_metrics_host_odd_nslots_and_tensor_input():
    x = _ook_waveform()
    h = eyeana.eye_metrics_host(torch.as_tensor(x), sps=SPS, nslots=301)
    j = jeyeana.eye_metrics(x, sps=SPS, nslots=301)
    assert h["y"].size == h["t"].size == j["y"].size
    for k in SCALARS:
        _same(h[k], j[k])


def test_degenerate_flat_input():
    """Flat waveform: no crossings, the fallback crossing times."""
    x = np.ones(256 * SPS)
    h = eyeana.eye_metrics_host(x, sps=SPS, nslots=256)
    j = jeyeana.eye_metrics(x, sps=SPS, nslots=256)
    assert (h["t_left"], h["t_right"], h["t_opt"]) == (-0.5, 0.5, 0.0)
    for k in SCALARS:
        _same(h[k], j[k])


@pytest.mark.parametrize("sps_resamp", [None, 64])
def test_get_eye_host_matches_jax_host(sps_resamp):
    x = _ook_waveform()
    noise = np.random.default_rng(9).normal(0, 0.01, x.size)
    t = TD.GET_EYE(ts.ElectricalSignal(x, noise), nslots=512,
                   sps_resamp=sps_resamp, engine="host")
    j = JD.GET_EYE(js.ElectricalSignal(x, noise), nslots=512,
                   sps_resamp=sps_resamp, engine="host")
    rel = 1e-9 if sps_resamp else 0.0
    for k in SCALARS:
        _same(getattr(t, k), getattr(j, k), rel)
    assert isinstance(t.mu1, float) and isinstance(t.i, int)
    assert t.dt == j.dt and t.execution_time > 0
    np.testing.assert_allclose(t.y, j.y, rtol=rel, atol=0)


def test_get_eye_host_two_pol_sum():
    """A 2-row input is summed over its rows first, as the JAX host engine
    does."""
    x = _ook_waveform()
    both = np.stack([0.6 * x, 0.4 * x])
    t = TD.GET_EYE(ts.OpticalSignal(both), nslots=256, engine="host")
    j = JD.GET_EYE(js.OpticalSignal(both), nslots=256, engine="host")
    for k in SCALARS:
        _same(getattr(t, k), getattr(j, k))


def test_engine_device_matches_host():
    x = _ook_waveform()
    sig = ts.ElectricalSignal(x)
    e_h = TD.GET_EYE(sig, nslots=512, engine="host")
    e_d = TD.GET_EYE(sig, nslots=512, engine="device")
    for k in ("mu0", "mu1", "s0", "s1", "t_left", "t_right", "t_opt",
              "t_dist", "threshold", "er", "eye_h", "i"):
        hv, dv = getattr(e_h, k), getattr(e_d, k)
        if hv is None:
            assert dv is None or np.isnan(dv)
        else:
            assert dv == pytest.approx(hv, rel=2e-4, abs=2e-5), k


@pytest.mark.parametrize("noise", [0.02, 0.05, 0.1, 0.15, 0.2])
def test_noisy_eye_agreement(noise):
    """The tensor engine's threshold stays within the KDE plateau of the
    host engine's (tests/test_eye_device.py TestNoisyThresholdBound)."""
    x = _ook_waveform(seed=3, noise=noise, nbits=2**11)
    h = eyeana.eye_metrics_host(x, sps=SPS, nslots=1024)
    d = {k: v.item() if isinstance(v, torch.Tensor) and v.ndim == 0 else v
         for k, v in eyeana.eye_metrics(
             torch.as_tensor(x, dtype=torch.float32), sps=SPS,
             nslots=1024).items()}
    for k in ("mu0", "mu1", "s0", "s1", "er", "eye_h"):
        assert d[k] == pytest.approx(h[k], rel=1e-4, abs=1e-6), (k, noise)
    plateau = max(h["threshold_plateau"], d["threshold_plateau"])
    grid_step = (h["mu1"] - h["mu0"]) / 499
    assert abs(d["threshold"] - h["threshold"]) <= \
        plateau + 2 * grid_step, (noise, plateau)
    assert plateau <= 0.5 * (h["mu1"] - h["mu0"]), (noise, plateau)
