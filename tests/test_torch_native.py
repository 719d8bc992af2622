"""The port's native host helpers (opticomlib_tpu_torch.native): the cases
of tests/test_native.py on the port, each function bit-equal to the JAX
package's ``opticomlib_tpu.native`` on the same inputs, the port's
vectorized PRBS against the port's LFSR, and the NumPy fallback (forced by
a failed build) giving the same results with a warning.  Everything is
exact: bits, counts and continuation states are compared for equality."""
import numpy as np
import pytest
import torch

from opticomlib_tpu import native as jnative
from opticomlib_tpu_torch import native
from opticomlib_tpu_torch.ops.prbs import PRBS_TAPS, prbs

ORDERS = sorted(PRBS_TAPS)
LENGTHS = (1, 7, 8, 9, 4097, 10_001)


def _bits(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.uint8)


# ---------------------------------------------------------------------------
# the cases of tests/test_native.py
# ---------------------------------------------------------------------------
def test_native_builds():
    assert native.available(), "g++ toolchain expected in this environment"
    lib = native.library_path()
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("order", ORDERS)
def test_lfsr_matches_vectorized_prbs(order):
    n = min(2 ** order - 1, 4096)
    bits_vec, state_vec = prbs(order, length=n)
    bits_nat, state_nat = native.lfsr_prbs(order, (1 << order) - 1, n)
    np.testing.assert_array_equal(bits_vec, bits_nat)
    assert state_vec == state_nat
    # continuation: 64 more bits from the returned states agree
    more_vec, _ = prbs(order, length=64, seed=state_vec)
    more_nat, _ = native.lfsr_prbs(order, state_nat, 64)
    np.testing.assert_array_equal(more_vec, more_nat)


def test_lfsr_full_period(order=11):
    """Full period 2^order - 1, then the stream repeats."""
    n = 2 ** order - 1
    bits, state = native.lfsr_prbs(order, (1 << order) - 1, n)
    assert int(bits.sum()) == 2 ** (order - 1)  # balance property
    again, _ = native.lfsr_prbs(order, state, n)
    np.testing.assert_array_equal(bits, again)


def test_bit_error_count():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, 10_001).astype(np.uint8)
    b = a.copy()
    flips = rng.choice(a.size, 137, replace=False)
    b[flips] ^= 1
    assert native.bit_error_count(a, b) == 137
    assert native.bit_error_count(a, a) == 0
    with pytest.raises(ValueError, match="same shape"):
        native.bit_error_count(a, b[:-1])


@pytest.mark.parametrize("n", (1, 7, 8, 9, 4097))
def test_pack_unpack_roundtrip(n):
    bits = _bits(n, 1)
    packed = native.pack_bits(bits)
    assert packed.size == (n + 7) // 8
    np.testing.assert_array_equal(native.unpack_bits(packed, n), bits)
    # NumPy's little-endian packbits convention
    np.testing.assert_array_equal(packed,
                                  np.packbits(bits, bitorder="little"))


# ---------------------------------------------------------------------------
# bit-equal to the JAX package's native library
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("order", ORDERS)
def test_lfsr_equals_jax(order):
    for n in LENGTHS:
        for seed in ((1 << order) - 1, 1, 0x5A5A5A5A % (1 << order) or 3):
            got, s_got = native.lfsr_prbs(order, seed, n)
            want, s_want = jnative.lfsr_prbs(order, seed, n)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            assert s_got == s_want


@pytest.mark.parametrize("n", LENGTHS)
def test_bit_error_count_pack_unpack_equal_jax(n):
    a, b = _bits(n, 2), _bits(n, 3)
    assert native.bit_error_count(a, b) == jnative.bit_error_count(a, b)
    packed = native.pack_bits(a)
    np.testing.assert_array_equal(packed, jnative.pack_bits(a))
    np.testing.assert_array_equal(native.unpack_bits(packed, n),
                                  jnative.unpack_bits(packed, n))


def test_unsupported_order_raises():
    with pytest.raises(ValueError, match="unsupported PRBS order"):
        native.lfsr_prbs(8, 1, 16)


@pytest.mark.parametrize("n_bits", (-1, 17))
def test_unpack_beyond_the_data_raises(n_bits):
    """More bits than the bytes hold (or fewer than none) is refused before
    the library could read past the buffer."""
    with pytest.raises(ValueError, match="bits asked of 2 bytes"):
        native.unpack_bits(np.zeros(2, np.uint8), n_bits)


def test_tensor_inputs_are_copied_to_the_host():
    a, b = _bits(4097, 4), _bits(4097, 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert native.bit_error_count(ta, tb) == int(np.sum(a != b))
    packed = native.pack_bits(ta)
    assert isinstance(packed, np.ndarray)
    np.testing.assert_array_equal(packed, jnative.pack_bits(a))
    np.testing.assert_array_equal(
        native.unpack_bits(torch.from_numpy(packed), a.size), a)


# ---------------------------------------------------------------------------
# the port's vectorized PRBS against the port's LFSR, every order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("order", ORDERS)
def test_prbs_equals_lfsr_at_every_length(order):
    for n in LENGTHS:
        seed = (1 << order) - 1
        bits, state = prbs(order, length=n, seed=seed)
        want, s_want = native.lfsr_prbs(order, seed, n)
        np.testing.assert_array_equal(bits, want)
        assert state == s_want


# ---------------------------------------------------------------------------
# the NumPy fallback
# ---------------------------------------------------------------------------
def test_fallback_without_compiler_same_results(monkeypatch, tmp_path):
    """A build that cannot run warns once and every function answers from
    NumPy, with the compiled library's results."""
    order, seed, n = 15, 12345, 10_001
    a, b = _bits(n, 6), _bits(n, 7)
    want = (native.lfsr_prbs(order, seed, n), native.bit_error_count(a, b),
            native.pack_bits(a))
    assert native.available()

    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.warns(RuntimeWarning, match="NumPy fallbacks"):
        assert not native.available()
    bits, state = native.lfsr_prbs(order, seed, n)
    np.testing.assert_array_equal(bits, want[0][0])
    assert state == want[0][1]
    assert native.bit_error_count(a, b) == want[1]
    packed = native.pack_bits(a)
    np.testing.assert_array_equal(packed, want[2])
    np.testing.assert_array_equal(native.unpack_bits(packed, n), a)
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))
