"""``LinkProgram.eye``, the batched eye metrology, the histogram range
estimator and the eye-density counts of the port, against the JAX package
and NumPy.

Tolerances: eye scalars rel 1e-4 against JAX (float32 reductions summed in
another order), the sampling instant equal; a row of the batched
``eye_metrics`` equals the 1-D call on that row exactly (the same
operations on the same values); ``shortest_int_hist`` bounds equal JAX's
(bin edges computed with the same float32 operations); density counts
equal ``np.histogram2d``'s exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws

from opticomlib_tpu import link as jlink
from opticomlib_tpu.ops import eyeana as jeye
from opticomlib_tpu.params import SimParams as JParams
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch.eyediag import Eye, eye_density
from opticomlib_tpu_torch.ops import eyeana as teye
from opticomlib_tpu_torch.ops.prbs import prbs
from opticomlib_tpu_torch.params import SimParams as TParams

torch.set_num_threads(2)

SPS, R, NBITS = 16, 10e9, 2**10
SCALARS = ("mu0", "mu1", "s0", "s1", "t_left", "t_right", "t_opt", "t_dist",
           "threshold", "er", "eye_h")
TRACES = ("y", "t", "y_top", "y_bot", "y_25_75")


def _progs(**kw):
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=0.75 * R,
                include_thermal=False, include_shot=False)
    base.update(kw)
    jprog = jlink.build_link(jlink.LinkSpec(**base), NBITS,
                             params=JParams.create(sps=SPS, R=R, _warn=False))
    tprog = tlink.build_link(tlink.LinkSpec(**base), NBITS, TParams.create(
        sps=SPS, R=R, _warn=False), device="cpu")
    return jprog, tprog


def _waveforms(n_ch=3, n_bits=1024, sps=16):
    """Gaussian-filtered NRZ channels with their own bits, levels and
    level-dependent noise."""
    rng = np.random.default_rng(5)
    k = np.exp(-0.5 * (np.arange(-2 * sps, 2 * sps + 1) / (0.3 * sps)) ** 2)
    rows = []
    for c in range(n_ch):
        x = np.repeat(rng.integers(0, 2, n_bits), sps).astype(np.float64)
        x = np.convolve(x, k / k.sum(), mode="same")
        sigma = np.where(x > 0.5, 0.05 + 0.01 * c, 0.08)
        rows.append(0.05 * c + (0.8 + 0.1 * c) * x
                    + sigma * rng.normal(size=x.size))
    return np.stack(rows).astype(np.float32)


# ---------------------------------------------------------------------------
# LinkProgram.eye (tests/test_eye_device.py::TestFusedLinkEye)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,sps_resamp", [
    (dict(), None), (dict(), 32),
    (dict(include_thermal=True, include_shot=True, P0=-12), None)])
def test_eye_matches_jax(kw, sps_resamp):
    jprog, tprog = _progs(**kw)
    bits = prbs(9, length=NBITS)[0]
    ej = jprog.eye(bits=bits, seed=3, nslots=512, sps_resamp=sps_resamp)
    et = tprog.eye(bits=bits, seed=3, nslots=512, sps_resamp=sps_resamp,
                   noise=jax_draws(3, NBITS * SPS, jprog.spec))
    for k in SCALARS:
        np.testing.assert_allclose(getattr(et, k), getattr(ej, k), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert et.i == ej.i and et.sps == ej.sps
    assert et.dt == ej.dt and et.y is None and et.empty


def test_eye_equals_dsp_eye_and_post_hoc_metrology():
    """One call chain + metrology == ``dsp``'s eye on the same settings ==
    ``eye_metrics`` on the ``run()`` output."""
    _, tprog = _progs(include_thermal=True, P0=-10)
    bits = prbs(9, length=NBITS)[0]
    e = tprog.eye(bits=bits, seed=2, nslots=512)
    d = tprog.dsp(bits=bits, seed=2, nslots=512, sps_resamp=None)
    m = teye.eye_metrics(tprog.run(bits=bits, seed=2).v, sps=SPS, nslots=512)
    for k in SCALARS:
        assert getattr(e, k) == getattr(d.eye, k) == m[k].item(), k


def test_eye_traces_only_when_requested():
    jprog, tprog = _progs()
    bits = prbs(9, length=NBITS)[0]
    assert tprog.eye(bits=bits, seed=0, nslots=512).y is None
    et = tprog.eye(bits=bits, seed=0, nslots=512, with_traces=True)
    ej = jprog.eye(bits=bits, seed=0, nslots=512, with_traces=True)
    for k in TRACES:
        tr = getattr(et, k)
        assert isinstance(tr, torch.Tensor) and tr.device == tprog.device
        assert tr.numel() == 512 * SPS
    np.testing.assert_allclose(et.t.numpy(), ej.t, atol=1e-6)
    np.testing.assert_allclose(et.y.numpy(), ej.y, rtol=1e-4, atol=1e-6)
    for k in ("y_top", "y_bot", "y_25_75"):
        np.testing.assert_array_equal(np.isnan(getattr(et, k).numpy()),
                                      np.isnan(getattr(ej, k)), err_msg=k)


def test_eye_validates_bits():
    _, tprog = _progs()
    with pytest.raises(ValueError, match="bits"):
        tprog.eye(bits=np.ones(7))


# ---------------------------------------------------------------------------
# batched eye_metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sps_resamp", [None, 32])
def test_batched_eye_metrics_rows_equal_the_1d_call(sps_resamp):
    y = torch.from_numpy(_waveforms())
    mb = teye.eye_metrics(y, sps=16, nslots=512, sps_resamp=sps_resamp)
    for c in range(y.shape[0]):
        m1 = teye.eye_metrics(y[c], sps=16, nslots=512,
                              sps_resamp=sps_resamp)
        assert set(m1) == set(mb)
        for k, v in m1.items():
            if isinstance(v, torch.Tensor):
                assert mb[k].shape == (y.shape[0],) + v.shape, k
                assert torch.equal(mb[k][c], v) or (
                    torch.isnan(v).any() and torch.equal(
                        torch.nan_to_num(mb[k][c]), torch.nan_to_num(v))), k
            else:
                assert mb[k] == v, k


def test_batched_eye_metrics_match_jax_vmap():
    import jax
    y = _waveforms()
    mj = jax.vmap(lambda r: jeye.eye_metrics_jax(r, sps=16, nslots=512))(
        jnp.asarray(y))
    mt = teye.eye_metrics(torch.from_numpy(y), sps=16, nslots=512)
    for k in SCALARS:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(mt["i"].numpy(), np.asarray(mj["i"]))


def test_eye_window_is_what_eye_metrics_reads():
    y = torch.from_numpy(_waveforms(1)[0])
    for n, nslots in ((y.numel(), 512), (y.numel(), 10**6), (16 * 37 + 5, 64)):
        w = teye.eye_window(n, 16, nslots)
        assert w % 32 == 0 and w <= min(n, nslots * 16)
        full = teye.eye_metrics(y[:n], sps=16, nslots=nslots)
        cut = teye.eye_metrics(y[:w], sps=16, nslots=nslots)
        assert full["y"].numel() == w
        assert all(torch.equal(torch.nan_to_num(full[k]),
                               torch.nan_to_num(cut[k])) for k in SCALARS)


# ---------------------------------------------------------------------------
# shortest_int_hist
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 20_000), (20_000,), (2, 2, 5_000)])
@pytest.mark.parametrize("percent,nbins", [(99.99, 8192), (50.0, 8192),
                                            (90.0, 512)])
def test_shortest_int_hist_matches_jax(shape, percent, nbins):
    rng = np.random.default_rng(8)
    y = (rng.normal(size=shape) * rng.uniform(0.5, 2.0, shape[:-1] + (1,))
         + rng.normal(size=shape[:-1] + (1,))).astype(np.float32)
    lo_j, hi_j = jeye.shortest_int_hist(jnp.asarray(y), percent, nbins)
    lo_t, hi_t = teye.shortest_int_hist(torch.from_numpy(y), percent, nbins)
    assert tuple(lo_t.shape) == shape[:-1] == tuple(hi_t.shape)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


def test_shortest_int_hist_tracks_the_sorted_estimator():
    """Up to bin quantisation: within two bin widths of the sort-based
    ``_shortest_int_masked`` on the same samples."""
    y = torch.from_numpy(_waveforms(1)[0])
    lo_s, hi_s = teye._shortest_int_masked(
        y, torch.ones_like(y, dtype=torch.bool), 99.0)
    lo_h, hi_h = teye.shortest_int_hist(y, 99.0)
    bw = float(y.max() - y.min()) / 8192
    assert abs(float(lo_h - lo_s)) <= 2 * bw
    assert abs(float(hi_h - hi_s)) <= 2 * bw


def test_shortest_int_hist_reduce_hooks_combine_blocks():
    """Two blocks of the sample axis with the hooks summing their
    histograms and taking the common range equal the unsplit call."""
    y = torch.from_numpy(_waveforms(2))
    a, b = y[:, :9000], y[:, 9000:]
    want = teye.shortest_int_hist(y, 99.0)
    lo_g = torch.minimum(a.min(-1).values, b.min(-1).values)
    hi_g = torch.maximum(a.max(-1).values, b.max(-1).values)
    hists = []

    def local_hist(block):
        teye.shortest_int_hist(
            block, 99.0, reduce_min=lambda _: lo_g, reduce_max=lambda _: hi_g,
            reduce_sum=lambda h: hists.append(h) or h)

    local_hist(a)
    local_hist(b)
    got = teye.shortest_int_hist(
        a, 99.0, reduce_min=lambda _: lo_g, reduce_max=lambda _: hi_g,
        reduce_sum=lambda _: hists[0] + hists[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# eye density
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nbins", [256, 64, 7])
def test_eye_density_equals_numpy_histogram2d(nbins):
    m = teye.eye_metrics(torch.from_numpy(_waveforms(1)[0]), sps=16,
                         nslots=512)
    t, y = m["t"], m["y_25_75"]          # a trace with NaN gaps
    H, te, ye = eye_density(t, y, nbins)
    ok = np.isfinite(y.numpy())
    Hn, ten, yen = np.histogram2d(t.numpy()[ok].astype(np.float64),
                                  y.numpy()[ok].astype(np.float64),
                                  bins=nbins)
    assert H.dtype == torch.float32 and H.shape == (nbins, nbins)
    np.testing.assert_array_equal(H.numpy(), Hn)
    np.testing.assert_array_equal(te, ten)
    np.testing.assert_array_equal(ye, yen)
    assert H.sum().item() == ok.sum()  # the right edges are counted


def test_eye_density_flat_trace_and_empty():
    H, te, _ = eye_density(torch.zeros(100), torch.linspace(0, 1, 100), 8)
    Hn, ten, _ = np.histogram2d(np.zeros(100), np.linspace(0, 1, 100,
                                                           dtype=np.float32
                                                           ).astype(float), 8)
    np.testing.assert_array_equal(H.numpy(), Hn)
    np.testing.assert_array_equal(te, ten)
    with pytest.raises(ValueError, match="finite"):
        eye_density(torch.full((4,), torch.nan), torch.zeros(4))


def test_eye_density_method_folds_like_plot():
    """``Eye.density`` against the NumPy lines of the JAX ``Eye.plot``
    (eyediag.py: the fold, ``np.histogram2d`` and the amplitude histogram of
    the decision window on the same edges)."""
    _, tprog = _progs(include_thermal=True, P0=-10)
    e = tprog.eye(seed=1, nslots=512, with_traces=True)
    occ, te, ye, hy = e.density(nbins=128)
    sps = e.sps
    y_ = np.roll(e.y.numpy().astype(np.float64), -sps // 2)[sps // 2:-sps // 2]
    t_ = e.t.numpy().astype(np.float64)[:-sps]
    occ_n, te_n, ye_n = np.histogram2d(t_, y_, bins=128)
    np.testing.assert_array_equal(occ.numpy(), occ_n)
    np.testing.assert_array_equal(ye, ye_n)
    sel = np.abs(e.t.numpy()[:-sps] - np.float32(e.t_opt)) <= np.float32(
        0.05 * e.t_dist)
    hy_n, _ = np.histogram(y_[sel], bins=ye_n)
    np.testing.assert_array_equal(hy.numpy(), hy_n)
    with pytest.raises(ValueError, match="traces"):
        Eye({"mu0": 0.0}).density()
