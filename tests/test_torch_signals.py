"""The port's staged-API state: the signal classes (NULL rules, the
signal/noise algebra, power/normalize/filter), ``gv`` and ``rng``, case for
case as tests/test_signals*.py, test_params.py and test_rng.py check the
JAX package's, each operation run through both packages on the same NumPy
inputs.  Tolerance: the same dtype as JAX, and values within 1e-12
relative (float64 / complex128 inputs; torch and NumPy may round a
reduction differently), except where a test says otherwise.
"""
import numpy as np
import pytest
import torch

import opticomlib_tpu as J
from opticomlib_tpu import signals as js
from opticomlib_tpu_torch import NULL, gv, rng, signals as ts
from opticomlib_tpu_torch.convert import gv_from_jax, signal_from_jax
from opticomlib_tpu_torch.devices import EDFA, LASER, PD

torch.set_num_threads(2)
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _reset():
    """A fresh ``gv`` on the CPU (its default device is the card)."""
    gv.default()
    gv.device = "cpu"
    rng.clear()
    yield
    gv.default()


def _data(n=64, noise=True, seed=11):
    r = np.random.default_rng(seed)
    s = r.normal(size=n) + 1j * r.normal(size=n)
    no = 0.1 * (r.normal(size=n) + 1j * r.normal(size=n)) if noise else None
    return s, no


def _pair(cls_name="ElectricalSignal", n=64, noise=True, seed=11):
    s, no = _data(n, noise, seed)
    args = (s,) if no is None else (s, no)
    return getattr(js, cls_name)(*args), getattr(ts, cls_name)(*args)


def _same(t, j):
    """A port signal equals a JAX one: signal and noise, dtype and values."""
    assert type(t).__name__ == type(j).__name__
    for a, b in ((t.signal, j.signal), (t.noise, j.noise)):
        if b is js.NULL:
            assert a is NULL
            continue
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-300)


# --------------------------------------------------------------- NULL rules
def test_null_absorbing():
    x = torch.arange(3.0)
    assert NULL + x is x and x + NULL is x
    assert NULL * x is NULL and x * NULL is NULL
    assert -NULL is NULL and NULL / 2 is NULL and NULL ** 2 is NULL
    assert NULL.conj() is NULL and NULL[1:] is NULL and not NULL
    assert x - NULL is x


def test_no_noise_stays_null():
    _, a = _pair(noise=False)
    _, b = _pair(noise=False, seed=12)
    for out in (a + b, a * b, a ** 2, -a, a / 3.0, a.conj(), a[3:9],
                a("w"), a.real, a.filter(np.ones(3))):
        assert out.noise is NULL


# ------------------------------------------------------------ the algebra
@pytest.mark.parametrize("op", [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: 2.0 - a, lambda a, b: a - 2.0, lambda a, b: a * 0.5,
    lambda a, b: 3 * a, lambda a, b: a / 2.0, lambda a, b: a / 2j,
    lambda a, b: -a, lambda a, b: a ** 2, lambda a, b: a ** 1,
    lambda a, b: a ** 3, lambda a, b: a.conj(), lambda a, b: a.sum(),
    lambda a, b: a.real, lambda a, b: a.imag, lambda a, b: a[4:12],
    lambda a, b: a("w"), lambda a, b: a("w", shift=True)("t", shift=True),
    lambda a, b: a // 2.0, lambda a, b: a.normalize("power"),
    lambda a, b: a.normalize("amplitude"),
], ids=["add", "sub", "mul", "rsub", "sub_scalar", "mul_scalar",
        "rmul_int", "div", "div_complex", "neg", "pow2", "pow1", "pow3",
        "conj", "sum", "real", "imag", "slice", "fft", "fft_shift_roundtrip",
        "floordiv_real", "normalize_power", "normalize_amplitude"])
def test_algebra_matches_jax(op):
    ja, ta = _pair()
    jb, tb = _pair(seed=12)
    try:
        jo = op(ja, jb)
    except TypeError:  # floor of complex: both packages refuse
        with pytest.raises((TypeError, RuntimeError)):
            op(ta, tb)
        return
    _same(op(ta, tb), jo)


def test_mul_bilinear_identity():
    """(s1+n1)(s2+n2) = s1 s2 + (s1 n2 + n1 s2 + n1 n2)."""
    _, a = _pair()
    _, b = _pair(seed=12)
    c = a * b
    np.testing.assert_allclose((c.signal + c.noise).numpy(),
                               ((a.signal + a.noise) * (b.signal + b.noise)
                                ).numpy(), rtol=1e-12)
    np.testing.assert_allclose(c.signal.numpy(),
                               (a.signal * b.signal).numpy())


def test_promotion_follows_numpy():
    """complex64 times host float64 data gives complex128, as NumPy arrays
    do; a Python scalar divisor keeps float32."""
    c64 = np.ones(8, np.complex64)
    assert (js.ElectricalSignal(c64) * np.float64(2)).dtype == np.complex128
    assert (ts.ElectricalSignal(c64) * np.float64(2)).dtype == torch.complex128
    f32 = ts.ElectricalSignal(np.ones(8, np.float32))
    assert (f32 / 3.0).dtype == torch.float32
    assert (f32 * np.ones(8)).dtype == torch.float64


def test_div_and_pow_errors():
    _, a = _pair()
    with pytest.raises(ZeroDivisionError):
        a / 0
    with pytest.raises(TypeError):
        a / "x"
    with pytest.raises(TypeError):
        a ** "x"
    np.testing.assert_array_equal((a ** 0).signal.numpy(), np.ones(64))


def test_comparisons_give_bits():
    for mod in (js, ts):
        x = mod.ElectricalSignal(np.array([0.1, 0.9, 0.4, 0.8]),
                                 np.array([0.0, 0.0, 0.2, -0.5]))
        assert isinstance(x > 0.5, mod.BinarySequence)
        np.testing.assert_array_equal((x > 0.5).data, [0, 1, 1, 0])
        np.testing.assert_array_equal((x < 0.5).data, [1, 0, 0, 1])
        with pytest.raises(TypeError):
            mod.OpticalSignal(np.ones(8)) > 0.5


@pytest.mark.parametrize("of", ["signal", "noise", "all"])
def test_power_and_abs(of):
    ja, ta = _pair()
    np.testing.assert_allclose(ta.abs(of).numpy(), ja.abs(of), rtol=RTOL)
    np.testing.assert_allclose(ta.power("W", of), ja.power("W", of),
                               rtol=1e-12)
    np.testing.assert_allclose(ta.power("dBm", of), ja.power("dBm", of),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        ta.power("V")
    with pytest.raises(ValueError):
        ta.abs("x")


def test_power_per_pol_and_mean_std():
    x = np.random.default_rng(2).normal(size=(2, 40)) + 0j
    j, t = js.OpticalSignal(x), ts.OpticalSignal(x)
    np.testing.assert_allclose(t.power(), j.power(), rtol=1e-12)
    np.testing.assert_allclose(t.mean(), j.mean(), rtol=1e-12)
    np.testing.assert_allclose(t.std(), j.std(), rtol=1e-12)


@pytest.mark.parametrize("h", [np.ones(5) / 5, np.array([0.2, 1j, 0.3])],
                         ids=["real_taps", "complex_taps"])
def test_filter_matches_jax(h):
    """Real taps take the ``fir_filter`` route (float32: within 1e-6 of the
    largest sample), complex taps the float64 FFT route."""
    ja, ta = _pair()
    jo, to = ja.filter(h), ta.filter(h)
    for a, b in ((to.signal, jo.signal), (to.noise, jo.noise)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * np.abs(b).max())


def test_apply_len_iter_array():
    ja, ta = _pair(n=24)
    _same(ta.apply(torch.exp), ja.apply(np.exp))
    assert len(ta) == 24 and ta.size == 24 and ta.shape == (24,)
    np.testing.assert_allclose(np.asarray(ta), np.asarray(ja), rtol=RTOL)
    np.testing.assert_allclose(list(ta), list(ja), rtol=RTOL)
    # ndarray attributes act on a host copy of signal + noise
    np.testing.assert_allclose(ta.max(), ja.max(), rtol=RTOL)


# ----------------------------------------------------------- construction
@pytest.mark.parametrize("shape,n_pol", [((16,), None), ((16,), 2),
                                         ((1, 16), None), ((1, 16), 1),
                                         ((2, 16), None), ((2, 16), 1),
                                         ((), None), ((), 2)])
def test_optical_polarizations(shape, n_pol):
    x = np.random.default_rng(3).normal(size=shape) + 0j
    j = js.OpticalSignal(x, x * 0.1, n_pol=n_pol)
    t = ts.OpticalSignal(x, x * 0.1, n_pol=n_pol)
    assert t.n_pol == j.n_pol and t.shape == np.shape(j.signal)
    _same(t, j)
    _same(t * np.exp(0.3j), j * np.exp(0.3j))
    if t.n_pol == 2:
        _same(t[0], j[0])
        assert t[0].n_pol == 1


def test_validation_matches_jax():
    for mod in (js, ts):
        with pytest.raises(ValueError, match="same shape"):
            mod.ElectricalSignal(np.ones(8), np.ones(4))
        with pytest.raises(ValueError, match="n_pol"):
            mod.OpticalSignal(np.ones(8), n_pol=3)
        with pytest.raises(ValueError, match="invalid shape"):
            mod.OpticalSignal(np.ones((3, 8)))
        with pytest.raises(ValueError, match="only 0s and 1s"):
            mod.BinarySequence([0, 1, 2])
        with pytest.raises(ValueError):
            mod.ElectricalSignal(np.ones(4))("q")


def test_scalar_noise_and_strings():
    for a, b in ((ts.ElectricalSignal(np.ones(4), 0.5),
                  js.ElectricalSignal(np.ones(4), 0.5)),
                 (ts.ElectricalSignal("1 2 3"), js.ElectricalSignal("1 2 3")),
                 (ts.ElectricalSignal(2.5), js.ElectricalSignal(2.5))):
        _same(a, b)


def test_binary_sequence():
    for text in ("1,0,1", "1 0 1", "101"):
        np.testing.assert_array_equal(ts.BinarySequence(text).data,
                                      [1, 0, 1])
    a = ts.BinarySequence([1, 0, 1, 1])
    b = ts.BinarySequence(torch.tensor([0, 0, 1, 0]))
    assert a.data.dtype == np.uint8 and (a + b).size == 8
    np.testing.assert_array_equal((a ^ b).data, [1, 0, 0, 1])
    np.testing.assert_array_equal((~a).data, [0, 1, 0, 0])
    assert (a * 2).size == 8 and a.ones == 3 and a.zeros == 1
    assert a.hamming_distance(b) == 2 and a[1] == 0
    np.testing.assert_array_equal(a.flip().data, (~a).data)
    np.testing.assert_array_equal(
        ts.BinarySequence.prbs(7, 20).data,
        js.BinarySequence.prbs(7, 20).data)


def test_tensors_keep_their_device_and_host_data_follows_gv():
    x = ts.ElectricalSignal(torch.ones(4, dtype=torch.float64))
    assert x.device.type == "cpu" and x.dtype == torch.float64
    assert (x * np.ones(4)).device.type == "cpu"


# -------------------------------------------------------------- gv and rng
def test_gv_facade_matches_jax():
    for g in (J.gv, gv):
        g.default()
        g(sps=8, R=2e9, N=32, foo=3)
        assert (g.sps, g.R, g.fs, g.N, g.foo) == (8, 2e9, 16e9, 32, 3)
        g(N=64)  # incremental update keeps the rates
        assert (g.sps, g.R, g.N) == (8, 2e9, 64)
        g.R = 4e9
        assert g.params.R == 4e9
        np.testing.assert_array_equal(g.t, np.linspace(0, 512 / 16e9, 512))
        with pytest.raises(AttributeError):
            g.nothing
        assert "foo" in str(g)
        g.default()
        assert g.sps == 16 and not hasattr(g, "foo")


def test_gv_device(monkeypatch):
    assert ts.ElectricalSignal(np.ones(3)).device.type == "cpu"
    gv.default()  # clears the device with the other extras
    assert not hasattr(gv, "device")
    gv(device="cpu")
    assert LASER(0).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gv(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gv.device = "cuda:0"
    assert gv.device == "cpu"


def test_no_device_named_means_the_card(monkeypatch):
    """With no device named the sources run on the card; without one the
    first source call raises and names ``device='cpu'``: no quiet CPU run."""
    from opticomlib_tpu_torch.devices import DAC, PRBS
    from opticomlib_tpu_torch.params import current_device
    gv.default()
    gv(sps=8, R=1e9, N=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert current_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tx = PRBS(order=7, len=16)  # host bits: no device yet
    for source in (lambda: LASER(0), lambda: DAC(tx, Vpp=1),
                   lambda: ts.ElectricalSignal(np.ones(3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            source()
    gv(device="cpu")
    assert LASER(0).device.type == "cpu"
    assert DAC(tx, Vpp=1).device.type == "cpu"


def test_gv_from_jax_and_signal_from_jax():
    J.gv(sps=32, R=5e9, N=48, wavelength=1310e-9)
    assert gv_from_jax(J.gv) is gv
    assert (gv.sps, gv.R, gv.fs, gv.N, gv.wavelength) == (
        32, 5e9, 160e9, 48, 1310e-9)
    for j in (js.ElectricalSignal(np.arange(5.0)),
              js.ElectricalSignal(np.arange(5, dtype=np.float32),
                                  np.ones(5, np.float32)),
              js.OpticalSignal(np.ones((2, 5), np.complex64), n_pol=2),
              js.OpticalSignal(J.ops.pulses.upsample_zero_stuff(
                  np.ones(3) + 0j, 2))):
        t = signal_from_jax(j)
        _same(t, j)
        assert t.n_pol == j.n_pol
    b = signal_from_jax(js.BinarySequence("1101"))
    np.testing.assert_array_equal(b.data, [1, 1, 0, 1])
    with pytest.raises(TypeError):
        signal_from_jax(np.ones(3))


def test_rng_stream():
    assert rng.resolve(None) is None
    gv(seed=42)
    assert rng.is_seeded()
    k1, k2 = rng.next_key(), rng.next_key()
    gv(seed=42)
    assert rng.next_key() == k1 != k2
    g = rng.resolve(5)
    assert isinstance(g, torch.Generator)
    assert torch.equal(torch.randn(3, generator=g),
                       torch.randn(3, generator=torch.Generator(
                       ).manual_seed(5)))
    gen = torch.Generator().manual_seed(1)
    assert rng.resolve(gen) is gen
    assert rng.resolve(np.uint32(7)) is not None
    gv.default()
    assert not rng.is_seeded()
    with pytest.raises(RuntimeError, match="not seeded"):
        rng.next_key()


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_keyed_laser_bit_equal_across_repeats_and_threads(threads):
    """One seed, one waveform, bit for bit: over repeated calls, with the
    key given as an int or as a generator, and whatever the number of intra-op
    threads (``exp`` and ``sqrt`` split these 4096 samples over two threads,
    the draws and the walk run on one)."""
    gv(sps=16, R=10e9, N=2**8)
    want = LASER(5, lw=1e6, rin=-140, key=7).to_numpy()
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for i in range(25):
            key = 7 if i % 2 else torch.Generator().manual_seed(7)
            np.testing.assert_array_equal(
                LASER(5, lw=1e6, rin=-140, key=key).to_numpy(), want)
    finally:
        torch.set_num_threads(before)


_FIRST_CALL = """
import sys, torch
sys.path.insert(0, {root!r})
import opticomlib_tpu_torch
torch.set_num_threads(8)
x = 1 + torch.randn(65536, generator=torch.Generator().manual_seed(7)) * 0.04
first = torch.sqrt(x)
torch.set_num_threads(1)
print(torch.equal(first, torch.sqrt(x)))
"""


def test_first_parallel_vector_math_call_after_import_is_exact():
    """The first vector-math call of a process (torch's CPU sqrt, exp...)
    split over several threads computes one thread's share on a
    low-accuracy path about once in thirty processes under load, unless a
    call on one thread came first (the package's import makes one).  Eight
    fresh processes at once, each a first parallel sqrt against a one-thread
    sqrt: without that call, about one run of this test in five sees a
    difference."""
    import subprocess
    import sys
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c",
                               _FIRST_CALL.format(root=root)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(8)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["True"] * 8, outs


def test_keyed_devices_reproducible():
    gv(sps=16, R=10e9, N=2**8)
    a = LASER(5, lw=1e6, rin=-140, key=7)
    b = LASER(5, lw=1e6, rin=-140, key=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    assert not np.array_equal(a.to_numpy(), LASER(5, lw=1e6, key=8).to_numpy())
    x = ts.OpticalSignal(np.ones(4096, complex) * 0.01)
    np.testing.assert_array_equal(EDFA(x, G=20, NF=5, key=3).noise.numpy(),
                                  EDFA(x, G=20, NF=5, key=3).noise.numpy())
    np.testing.assert_array_equal(
        PD(x, BW=7.5e9, include_noise="thermal-shot", key=11).noise.numpy(),
        PD(x, BW=7.5e9, include_noise="thermal-shot", key=11).noise.numpy())
    gv(seed=42)
    s1, s2 = LASER(5, lw=1e6), LASER(5, lw=1e6)
    gv(seed=42)
    np.testing.assert_array_equal(s1.to_numpy(), LASER(5, lw=1e6).to_numpy())
    assert not np.array_equal(s1.to_numpy(), s2.to_numpy())
