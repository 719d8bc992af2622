"""The port's ADC quantiser (opticomlib_tpu_torch.ops.kernels.adc_quantize*)
against the JAX package, in its two modes:

* link mode (``adc_quantize_link``, the fused link's ``adc_bits`` stage):
  the plain version equals ``opticomlib_tpu.link._adc_quantize`` bit for
  bit, range estimate included; under ``jax.jit`` XLA on the CPU rewrites
  the last line as ``fma(code, (hi-lo)*(1/nq), lo)``, so there the codes
  are equal and the outputs within one float32 ulp;
* kernel mode (``adc_quantize``, the TPU kernel ``pk.adc_quantize`` run in
  interpret mode as tests/test_pallas.py runs it): equal codes, outputs
  within one ulp (the interpreter contracts ``lo + q*step`` into an FMA);
  ties round half up where the link rounds half to even;
* stochastic rounding: statistics only (on the grid, unbiased to 3 sigma,
  seeded).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticomlib_tpu import link as jlink
from opticomlib_tpu.ops import eyeana as jeye
from opticomlib_tpu.ops import pallas_kernels as pk
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _voltage(n=4099, seed=0):
    """A PD-like voltage: two levels with noise and a few far outliers
    outside the 99.99 % range."""
    rng = np.random.default_rng(seed)
    v = np.where(rng.integers(0, 2, n) > 0, 0.24, 0.017)
    v = v + 0.012 * rng.normal(size=n)
    v[rng.integers(0, n, 3)] += np.array([0.2, -0.15, 0.3])
    return v.astype(np.float32)


@pytest.mark.parametrize("bits", [1, 6, 8, 12, 16])
def test_link_mode_bit_equal_to_jax(bits):
    v = _voltage()
    want = np.asarray(jlink._adc_quantize(jnp.asarray(v), bits))
    got = tlink._adc_quantize(torch.from_numpy(v), bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) <= 2 ** bits + 6  # + the outliers


def test_link_mode_codes_equal_to_jitted_jax():
    v = _voltage(seed=1)
    bits = 8
    want = np.asarray(jax.jit(lambda v: jlink._adc_quantize(v, bits))(v))
    got = tlink._adc_quantize(torch.from_numpy(v), bits).numpy()
    lo, hi = (np.float64(a) for a in jeye._shortest_int_masked(
        v, np.ones(v.shape, bool), 99.99))
    step = (hi - lo) / (2 ** bits - 1)
    codes = np.round((got - lo) / step)
    np.testing.assert_array_equal(codes, np.round((want - lo) / step))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.abs(want).max()))


def test_link_mode_rounds_half_even_and_does_not_clip():
    """On [0, 1] at one bit the code is ``round(v)``: ties go to even, and
    samples outside the range extrapolate (the kernel mode would clip)."""
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.0, 0.25], np.float32)
    lo, hi = torch.tensor(np.float32(0)), torch.tensor(np.float32(1))
    got = kernels.adc_quantize_link(torch.from_numpy(v), lo, hi, 1).numpy()
    nq = jnp.float32(1)
    want = np.asarray(jnp.round((v - 0) / (1 - 0) * nq) / nq * (1 - 0) + 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 2, 2, -0.0, -1, 0])


@pytest.mark.parametrize("n,lo,hi,nbits", [(2000, -2.0, 2.0, 4),
                                           (70_001, -1.0, 3.0, 8)])
def test_kernel_mode_matches_pallas(n, lo, hi, nbits):
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    want = np.asarray(pk.adc_quantize(x, lo, hi, nbits))
    got = kernels.adc_quantize(torch.from_numpy(x), lo, hi, nbits).numpy()
    step = np.float32((hi - lo) / (2 ** nbits - 1))
    codes = np.round((got - np.float32(lo)) / step)
    np.testing.assert_array_equal(
        codes, np.round((want - np.float32(lo)) / step))
    assert codes.min() >= 0 and codes.max() <= 2 ** nbits - 1  # clipped
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.float32(max(abs(lo),
                                                              abs(hi)))))


def test_kernel_mode_rounds_half_up():
    """Exact ties on a unit step: the TPU kernel's floor(q + 0.5) rounds
    every one up, where the link's half-even rounding keeps even codes."""
    x = np.arange(15, dtype=np.float32) + np.float32(0.5)
    want = np.asarray(pk.adc_quantize(x, 0.0, 15.0, 4))
    got = kernels.adc_quantize(torch.from_numpy(x), 0.0, 15.0, 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(1, 16))
    assert not np.array_equal(got, np.round(x))


def test_stochastic_on_grid_unbiased_and_seeded():
    x = torch.full((200_000,), 0.30)
    lo, hi, nbits = 0.0, 1.0, 2   # levels at 0, 1/3, 2/3, 1
    y = kernels.adc_quantize(x, lo, hi, nbits, stochastic=True, seed=3)
    step = np.float32((hi - lo) / (2 ** nbits - 1))
    q = y.numpy() / step
    np.testing.assert_allclose(q, np.round(q), atol=1e-4)
    assert set(np.round(q).astype(int)) == {0, 1}  # 0.3 lies in [0, 1/3]
    assert abs(float(y.mean()) - 0.30) < 3 * step / np.sqrt(12 * len(x))
    again = kernels.adc_quantize(x, lo, hi, nbits, stochastic=True, seed=3)
    other = kernels.adc_quantize(x, lo, hi, nbits, stochastic=True, seed=4)
    assert torch.equal(y, again) and not torch.equal(y, other)
    # every block of 65,536 samples gets its own dither
    assert not torch.equal(y[:65536], y[65536:131072])
