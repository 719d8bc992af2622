"""The port's eye metrology (opticomlib_tpu_torch.ops.eyeana.eye_metrics)
against the JAX device twin (opticomlib_tpu.ops.eyeana.eye_metrics_jax) on
one waveform, with and without FFT resampling.

Scalars within rel 1e-4 (float32 reductions summed in another order); the
sampling instant ``i`` exactly.  The KDE histogram goes through the port's
``kernels.histogram2d`` wrapper (its plain version on the CPU).
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu.ops import eyeana as jeye
from opticomlib_tpu_torch.ops import eyeana as teye

torch.set_num_threads(2)

SCALARS = ("mu0", "mu1", "s0", "s1", "threshold", "t_opt", "er", "t_left",
           "t_right", "eye_h", "y_left", "y_right")


def _waveform(n_bits=2048, sps=16, seed=11):
    """Gaussian-filtered NRZ with level-dependent noise (an eye with a
    smooth KDE minimum between the levels)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits)
    x = np.repeat(bits, sps).astype(np.float64)
    k = np.exp(-0.5 * (np.arange(-2 * sps, 2 * sps + 1) / (0.3 * sps)) ** 2)
    x = np.convolve(x, k / k.sum(), mode="same")
    sigma = np.where(x > 0.5, 0.06, 0.09)
    return (0.05 + 0.9 * x + sigma * rng.normal(size=x.size)).astype(
        np.float32), sps


@pytest.mark.parametrize("sps_resamp", [None, 32])
def test_eye_metrics_match_jax(sps_resamp):
    y, sps = _waveform()
    mj = jeye.eye_metrics_jit(y, sps=sps, nslots=1024, sps_resamp=sps_resamp)
    mt = teye.eye_metrics(torch.from_numpy(y), sps=sps, nslots=1024,
                          sps_resamp=sps_resamp)
    for k in SCALARS:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert int(mt["i"]) == int(mj["i"])
    np.testing.assert_allclose(mt["top_int"].numpy(), np.asarray(
        mj["top_int"]), rtol=1e-4)
    np.testing.assert_allclose(mt["y"].numpy(), np.asarray(mj["y"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("a,b,num", [(0.0568, 1.0098, 1000),
                                      (0.05682, 1.0098, 1000),
                                      (0.0174689, 0.2405096, 1000),
                                      (-0.3, 0.7, 1000)])
def test_linspace_matches_jnp(a, b, num):
    """Ascending ranges (the receiver's scan from mu0 to mu1): every grid
    point equal to jnp.linspace's, which XLA on the CPU evaluates with
    contracted FMAs."""
    import jax.numpy as jnp
    a32, b32 = np.float32(a), np.float32(b)
    got = teye.linspace(torch.tensor(a32), torch.tensor(b32), num)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.linspace(a32, b32, num)))


def test_linspace_descending_within_one_ulp():
    import jax.numpy as jnp
    a32, b32 = np.float32(0.3), np.float32(-0.2)
    got = teye.linspace(torch.tensor(a32), torch.tensor(b32), 500)
    want = np.asarray(jnp.linspace(a32, b32, 500))
    assert got[0].item() == want[0] and got[-1].item() == want[-1]
    ulp = np.spacing(max(abs(a32), abs(b32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ulp)


@pytest.mark.parametrize("m", [2**24, 2**24 - 1, 4099, 12345])
def test_shortest_int_lag_matches_jax(m):
    """The window length of the 99.99 % interval (the ADC's range) at the
    slice's 2^24 samples, where m*99.99 in float32 has an ulp of 128."""
    import jax
    import jax.numpy as jnp
    lag_j = jax.jit(lambda m: jnp.maximum(
        (m * 99.99 / 100.0).astype(jnp.int32), 1))(jnp.int32(m))
    assert int(teye._lag(torch.tensor(m), 99.99)) == int(lag_j)


def test_quantiles_match_jnp():
    import jax.numpy as jnp
    y = np.random.default_rng(3).normal(size=10_001).astype(np.float32)
    got = teye._quantiles(torch.from_numpy(y), (0.1, 0.9))
    for g, q in zip(got, (0.1, 0.9)):
        assert g.item() == float(jnp.quantile(y, q))


def test_shortest_int_masked_matches_jax():
    rng = np.random.default_rng(4)
    y = rng.normal(size=4099).astype(np.float32)
    mask = y > -0.3
    lo_j, hi_j = jeye._shortest_int_masked(y, mask, 50)
    lo_t, hi_t = teye._shortest_int_masked(torch.from_numpy(y),
                                           torch.from_numpy(mask), 50)
    assert (lo_t.item(), hi_t.item()) == (float(lo_j), float(hi_j))
