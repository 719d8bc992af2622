"""The port's FIR shaping (opticomlib_tpu_torch.ops.kernels.fir_filter and
ops.pulses.fft_convolve_same / upfir) against the JAX package on the same
NumPy inputs.

* ``fir_filter_ref`` (the plain version the wrapper runs on CPU tensors)
  against the Pallas ``fir_filter`` in interpret mode and ``np.convolve``:
  float32 sums in another order, so within 1e-5 of max|y| (rtol 1e-4,
  atol 1e-4 as ``TestFIR`` for random taps).
* ``upfir`` against ``opticomlib_tpu.ops.pulses.upfir`` (float64 FFT
  convolution): the kernel route computes in float32, so within 2e-6 of
  max|y|; the FFT route is float64, within 1e-12 of max|y|.
* the route rule: the kernel route exactly when the taps are real and at
  most ``FIR_MAX_TAPS`` are left after trimming their float32 zero ends.
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu.ops import pallas_kernels as pk
from opticomlib_tpu.ops import pulses as jpulses
from opticomlib_tpu_torch.ops import kernels, pulses

torch.set_num_threads(2)


def _gauss783():
    """The DAC's default gaussian taps at sps 64, trimmed in float32: 783."""
    h = jpulses.gauss_pulse(span=60, sps=64).real.astype(np.float32)
    nz = np.flatnonzero(h)
    return h[nz[0]:nz[-1] + 1]


@pytest.mark.parametrize("taps,n,block", [(7, 1000, 256), (33, 4096, 512),
                                          (783, 5000, 1024), (1, 600, 256),
                                          (8, 1000, 256), (9, 1001, 256)])
def test_fir_ref_matches_pallas_and_convolve(taps, n, block):
    rng = np.random.default_rng(taps)
    x = rng.normal(size=n).astype(np.float32)
    h = (_gauss783() if taps == 783 else
         rng.normal(size=taps).astype(np.float32))
    y = kernels.fir_filter(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    expect = np.convolve(x.astype(np.float64), h.astype(np.float64))[:n]
    tol = 1e-5 * np.abs(expect).max()
    np.testing.assert_allclose(y, expect, rtol=0, atol=tol)
    pallas = np.asarray(pk.fir_filter(x, h, block=block))
    np.testing.assert_allclose(y, pallas, rtol=0, atol=tol)
    assert kernels.LAUNCHES["fir_filter"] == 0  # CPU: the plain version


def test_fir_delta_filter_is_identity():
    x = np.random.default_rng(1).normal(size=777).astype(np.float32)
    h = np.zeros(11, np.float32)
    h[0] = 1.0
    y = kernels.fir_filter(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_array_equal(y.numpy(), x)


def test_fir_more_taps_than_samples():
    rng = np.random.default_rng(2)
    x = rng.normal(size=5).astype(np.float32)
    h = rng.normal(size=40).astype(np.float32)
    y = kernels.fir_filter(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(y, np.convolve(x, h)[:5], atol=1e-6)


def test_fir_validation():
    x = torch.zeros(16)
    with pytest.raises(TypeError):
        kernels.fir_filter(x.double(), torch.ones(3))
    with pytest.raises(ValueError, match="taps"):
        kernels.fir_filter(x, torch.ones(kernels.FIR_MAX_TAPS + 1))
    with pytest.raises(ValueError, match="taps"):
        kernels.fir_filter(x, torch.ones(0))
    with pytest.raises(ValueError, match="1-D"):
        kernels.fir_filter(x.reshape(4, 4), torch.ones(3))


def _cases():
    span, sps = 12, 8
    m = span * sps + 1
    rng = np.random.default_rng(3)
    return {
        "nrz": jpulses.nrz_pulse(span, sps),
        "nrz_T3": jpulses.nrz_pulse(span, sps, T=3),
        "gauss": jpulses.gauss_pulse(span, sps).real,
        "gauss_m2_T2": jpulses.gauss_pulse(span, sps, T=2, m=2).real,
        "gauss_chirp": jpulses.gauss_pulse(span, sps, c=0.4),
        "rcos_normal": jpulses.rcos_pulse(0.25, span, sps, "normal"),
        "rcos_sqrt": jpulses.rcos_pulse(0.5, span, sps, "sqrt"),
        "custom_even": rng.normal(size=16),
        "custom_late": np.concatenate([np.zeros(70), rng.normal(size=9)]),
        "long": rng.normal(size=kernels.FIR_MAX_TAPS + 10),
        "m": m,
    }


@pytest.mark.parametrize("name", ["nrz", "nrz_T3", "gauss", "gauss_m2_T2",
                                  "gauss_chirp", "rcos_normal", "rcos_sqrt",
                                  "custom_even", "custom_late", "long"])
@pytest.mark.parametrize("nbits", [40, 41])
def test_upfir_matches_jax(name, nbits):
    """Odd and even lengths, every pulse shape, custom taps that start past
    the kernel's centre (a negative advance) and taps past the limit."""
    h = _cases()[name]
    sps = 8
    bits = np.random.default_rng(nbits).integers(0, 2, nbits)
    if name == "long":  # long taps need a long input to matter
        bits = np.tile(bits, 40)
    expect = np.asarray(jpulses.upfir(bits, h, up=sps))
    got = pulses.upfir(torch.as_tensor(bits.astype(np.float64)), h,
                       up=sps).numpy()
    assert got.dtype == expect.dtype
    kernel_route = pulses.fir_taps(h) is not None
    tol = (2e-6 if kernel_route else 1e-12) * np.abs(expect).max()
    np.testing.assert_allclose(got, expect, rtol=0, atol=tol)


@pytest.mark.parametrize("n", [63, 64])
def test_fft_convolve_same_complex_input(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    h = jpulses.gauss_pulse(4, 8).real
    expect = np.asarray(jpulses.fft_convolve_same(x, h))
    got = pulses.fft_convolve_same(torch.as_tensor(x), h).numpy()
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, expect, atol=2e-6 * np.abs(expect).max())


def test_route_rule():
    c = _cases()
    for name in ("nrz", "gauss", "rcos_normal", "custom_late"):
        taps, _ = pulses.fir_taps(c[name])
        assert taps.dtype == np.float32 and taps[0] != 0 and taps[-1] != 0
    assert pulses.fir_taps(c["gauss_chirp"]) is None  # complex taps
    assert pulses.fir_taps(c["long"]) is None         # past the limit
    # exactly the limit after trimming zero ends takes the kernel
    h = np.concatenate([np.zeros(5), np.ones(kernels.FIR_MAX_TAPS),
                        np.zeros(7)])
    taps, s = pulses.fir_taps(h)
    assert taps.size == kernels.FIR_MAX_TAPS
    assert s == (h.size - 1) // 2 - 5
    h[4] = 1e-300  # nonzero in float64, zero in float32: still trimmed
    assert pulses.fir_taps(h)[0].size == kernels.FIR_MAX_TAPS
    h[4] = 1e-30   # nonzero in float32: one tap too many
    assert pulses.fir_taps(h) is None


def test_kernel_route_launches_fir_filter_only_on_cuda(monkeypatch):
    """The kernel route calls ``kernels.fir_filter`` (the plain version on
    the CPU, so no launch is counted); the FFT route never does."""
    calls = []
    real = kernels.fir_filter
    monkeypatch.setattr(kernels, "fir_filter",
                        lambda x, h: calls.append(h.numel()) or real(x, h))
    x = torch.zeros(256, dtype=torch.float64)
    pulses.fft_convolve_same(x, _cases()["gauss"])
    assert calls and kernels.LAUNCHES["fir_filter"] == 0
    calls.clear()
    pulses.fft_convolve_same(x, _cases()["gauss_chirp"])
    assert not calls


def test_windowed_pulses_equal_the_full_grid():
    """The DAC evaluates the nrz and gaussian taps only on a window of the
    grid: the same floats as the full grid's."""
    span, sps = 1020, 64
    full = jpulses.gauss_pulse(span, sps, T=2, m=1).real
    win = (span * sps // 2 - 900, span * sps // 2 + 901)
    part = pulses.gauss_pulse(span, sps, T=2, window=win).real
    np.testing.assert_array_equal(part, full[win[0]:win[1]])
    ends = (0, 50), (span * sps - 40, span * sps + 1)
    for w in ends:
        np.testing.assert_array_equal(
            pulses.nrz_pulse(span, sps, T=1, window=w),
            jpulses.nrz_pulse(span, sps, T=1)[w[0]:w[1]])
