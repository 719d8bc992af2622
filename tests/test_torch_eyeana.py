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
from torch.utils._python_dispatch import TorchDispatchMode

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


class _HostReads(TorchDispatchMode):
    """Counts the operations that wait for the card: a tensor read back
    to a Python number (``_local_scalar_dense``: ``.item()``, an index by a
    0-d tensor) and a tensor made from host data (``lift_fresh``: on the
    card, a host-to-device copy)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in ("_local_scalar_dense", "lift_fresh"):
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0),
                       torch.nan_to_num(b, nan=7.0))


@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("sps_resamp", [None, 32])
def test_eye_and_decide_wait_for_nothing(rows, sps_resamp):
    """The scalars path of the receiver (``eye_scalars``, then
    ``link._ook_decide``) reads nothing back and copies nothing from the
    host, so a CUDA graph can hold it; it gives ``eye_metrics``' scalars bit
    for bit, and its packed rows hold the same values."""
    from opticomlib_tpu_torch import link
    y = np.stack([_waveform(n_bits=256, seed=s)[0] for s in range(rows)])
    x = torch.from_numpy(y if rows > 1 else y[0])
    teye.eye_scalars(x, sps=16, nslots=1024, sps_resamp=sps_resamp)
    with _HostReads() as reads:
        e = teye.eye_scalars(x, sps=16, nslots=1024, sps_resamp=sps_resamp)
        for c in range(rows):
            m = {k: e.m[k] if rows == 1 else e.m[k][c]
                 for k in ("mu0", "mu1", "s0", "s1")}
            slots = x.reshape(rows, -1)[c, 8::16]
            link._ook_decide(m, slots, (slots > 0.5).to(torch.float32))
    assert reads.counts == {}
    assert e.how == "eager" and e.rows.shape[0] == rows
    full = teye.eye_metrics(x, sps=16, nslots=1024, sps_resamp=sps_resamp)
    host = teye.unpack_rows(e.rows.numpy(), e.layout)
    assert list(host) == [k for k, v in full.items()
                          if isinstance(v, torch.Tensor)
                          and k not in ("y", "t", "y_top", "y_bot",
                                        "y_25_75")]
    for k in host:
        assert _same(e.m[k], full[k]), k
        assert e.m[k].dtype == full[k].dtype, k
        np.testing.assert_array_equal(
            host[k].reshape(e.m[k].shape), e.m[k].numpy(), err_msg=k)


def _fallback_input(case):
    y, sps = _waveform()
    if case == "constant":
        return np.full_like(y, 0.7)
    if case == "no_crossing":   # two levels, no sample between 25 and 75 %
        bits = np.random.default_rng(5).integers(0, 2, y.size // sps)
        return (0.05 + 0.9 * np.repeat(bits, sps)).astype(np.float32)
    return np.where(np.arange(y.size) % 997 == 0, np.nan, y).astype(
        np.float32)


@pytest.mark.parametrize("case", ["constant", "no_crossing", "nan"])
def test_fallback_inputs_match_jax_and_wait_for_nothing(case):
    """The inputs that take the fallbacks (no crossing band: the default
    crossing times and NaN levels; a constant waveform; NaN samples) give
    the JAX device engine's scalars, as ``test_eye_metrics_match_jax``
    holds them, with nothing read back on the way."""
    y = _fallback_input(case)
    mj = jeye.eye_metrics_jit(y, sps=16, nslots=1024, sps_resamp=None)
    x = torch.from_numpy(y)
    teye.eye_scalars(x, sps=16, nslots=1024)
    with _HostReads() as reads:
        mt = teye.eye_scalars(x, sps=16, nslots=1024).m
    assert reads.counts == {}
    for k in SCALARS:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert int(mt["i"]) == int(mj["i"])
    if case == "no_crossing":
        assert (mt["t_left"].item(), mt["t_right"].item()) == (-0.5, 0.5)
        assert np.isnan(mt["y_left"].item())
