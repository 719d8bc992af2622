"""The NumPy protocol of the port's signal classes (``__array_ufunc__``,
``__array_function__``, ndarray attribute delegation), case for case as
tests/test_numpy_protocol.py checks the JAX package's (reference
typing.py:518-692 and 1224-1306), each case also run through the JAX
classes on the same inputs and held equal to them (the same float64 host
arithmetic: equal to the last bit).  A re-wrapped result lies on the
operand's device.
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu import signals as js
from opticomlib_tpu_torch import gv
from opticomlib_tpu_torch.signals import (NULL, BinarySequence,
                                          ElectricalSignal, OpticalSignal)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu():
    gv.default()
    gv.device = "cpu"
    yield
    gv.default()


def _same(t, j):
    """A port result equals the JAX one: same class name, same values."""
    assert type(t).__name__ == type(j).__name__
    if isinstance(j, js.BinarySequence):
        np.testing.assert_array_equal(t.data, j.data)
        return
    if isinstance(j, js.ElectricalSignal):
        for a, b in ((t.signal, j.signal), (t.noise, j.noise)):
            if b is js.NULL:
                assert a is NULL
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _both(fn, *args_by_cls):
    """``fn`` on port objects and on JAX objects built from the same data:
    ``args_by_cls`` are ``(class name, args...)`` tuples or plain values."""
    def build(mod):
        out = []
        for a in args_by_cls:
            if isinstance(a, tuple) and a and isinstance(a[0], str):
                name, *rest = a
                kw = rest.pop() if rest and isinstance(rest[-1], dict) else {}
                out.append(getattr(mod, name)(*rest, **kw))
            else:
                out.append(a)
        return out
    import opticomlib_tpu_torch.signals as ts
    t, j = fn(*build(ts)), fn(*build(js))
    _same(t, j)
    return t


class TestElectricalUfuncs:
    def test_np_abs_rewraps(self):
        out = _both(np.abs, ("ElectricalSignal", [3.0, -4.0, 5.0]))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_array_equal(out.signal, [3.0, 4.0, 5.0])

    def test_np_exp_rewraps(self):
        out = _both(np.exp, ("ElectricalSignal", [0.0, 1.0]))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_allclose(out.signal, np.exp([0.0, 1.0]))

    def test_ufunc_acts_on_signal_plus_noise(self):
        out = _both(np.abs, ("ElectricalSignal", [1.0, 2.0],
                             {"noise": [0.5, 0.5]}))
        np.testing.assert_allclose(np.asarray(out), [1.5, 2.5])

    def test_np_add_preserves_noise_algebra(self):
        out = _both(np.add, np.array([10.0, 20.0]),
                    ("ElectricalSignal", [1.0, 2.0], {"noise": [0.1, 0.2]}))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_allclose(out.signal, [11.0, 22.0])
        np.testing.assert_allclose(out.noise, [0.1, 0.2])

    def test_np_multiply_bilinear(self):
        out = _both(np.multiply, np.array([2.0, 3.0]),
                    ("ElectricalSignal", [1.0, 2.0], {"noise": [0.1, 0.2]}))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_allclose(out.signal, [2.0, 6.0])
        np.testing.assert_allclose(out.noise, [0.2, 0.6])

    def test_np_subtract_reflected(self):
        out = _both(np.subtract, np.array([10.0, 10.0]),
                    ("ElectricalSignal", [1.0, 2.0]))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_allclose(np.asarray(out), [9.0, 8.0])

    def test_scalar_results_pass_through(self):
        sig = ElectricalSignal([1.0, 2.0, 3.0])
        assert float(np.mean(sig)) == pytest.approx(2.0)
        assert float(np.mean(sig)) == float(np.mean(
            js.ElectricalSignal([1.0, 2.0, 3.0])))


class TestElectricalArrayFunctions:
    def test_concatenate_rewraps(self):
        out = _both(lambda a, b: np.concatenate([a, b]),
                    ("ElectricalSignal", [1.0, 2.0]),
                    ("ElectricalSignal", [3.0, 4.0]))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_array_equal(np.asarray(out), [1, 2, 3, 4])

    def test_roll_rewraps(self):
        out = _both(lambda a: np.roll(a, 1),
                    ("ElectricalSignal", [1.0, 2.0, 3.0]))
        assert isinstance(out, ElectricalSignal)
        np.testing.assert_array_equal(np.asarray(out), [3, 1, 2])

    def test_fft_rewraps(self):
        out = _both(np.fft.fft, ("ElectricalSignal", np.ones(8)))
        assert isinstance(out, ElectricalSignal)
        assert np.asarray(out)[0] == pytest.approx(8.0)


class TestAttributeDelegation:
    def test_var_max_cumsum(self):
        sig = ElectricalSignal([1.0, 2.0, 3.0], noise=[0.0, 0.0, 0.0])
        assert sig.var() == pytest.approx(np.var([1, 2, 3]))
        assert sig.max() == 3.0
        np.testing.assert_array_equal(sig.cumsum(), [1, 3, 6])

    def test_existing_members_not_shadowed(self):
        sig = ElectricalSignal([1.0, 2.0], noise=[0.5, 0.5])
        out = sig.sum()
        assert isinstance(out, ElectricalSignal)
        assert sig.mean() == pytest.approx(2.0)

    def test_missing_attribute_raises(self):
        sig = ElectricalSignal([1.0])
        with pytest.raises(AttributeError):
            sig.definitely_not_an_attribute


class TestOpticalWrapping:
    def test_np_abs_two_pol(self):
        out = _both(np.abs, ("OpticalSignal",
                             np.ones((2, 8), complex) * (3 + 4j)))
        assert isinstance(out, OpticalSignal)
        assert out.n_pol == 2
        np.testing.assert_allclose(np.asarray(out.signal), 5.0)

    def test_np_multiply_optical(self):
        out = _both(np.multiply, np.full(8, 2.0),
                    ("OpticalSignal", np.ones(8, complex)))
        assert isinstance(out, OpticalSignal)


class TestBinarySequenceProtocol:
    def test_np_add_is_concatenation(self):
        out = _both(np.add, np.array([0, 0, 0], dtype=np.uint8),
                    ("BinarySequence", "101"))
        assert isinstance(out, BinarySequence)
        np.testing.assert_array_equal(out.data, [0, 0, 0, 1, 0, 1])

    def test_np_roll_rewraps(self):
        out = _both(lambda s: np.roll(s, 1), ("BinarySequence", "100"))
        assert isinstance(out, BinarySequence)
        np.testing.assert_array_equal(out.data, [0, 1, 0])

    def test_np_concatenate(self):
        out = _both(lambda a, b: np.concatenate([a, b]),
                    ("BinarySequence", "10"), ("BinarySequence", "01"))
        assert isinstance(out, BinarySequence)
        np.testing.assert_array_equal(out.data, [1, 0, 0, 1])

    def test_nonbinary_result_falls_back_to_ndarray(self):
        seq = BinarySequence("111")
        out = _both(lambda s: np.add(s, s), ("BinarySequence", "111"))
        assert isinstance(out, BinarySequence) and out.size == 6
        out2 = np.multiply(seq.data, 3)  # plain ndarray path
        assert isinstance(out2, np.ndarray)
        # a ufunc whose result is not binary comes back as an ndarray
        out3 = _both(np.exp, ("BinarySequence", "101"))
        assert isinstance(out3, np.ndarray)
        np.testing.assert_allclose(out3, np.exp([1, 0, 1]), rtol=1e-3)  # float16 of uint8

    def test_delegation(self):
        seq = BinarySequence("1011")
        assert seq.sum() == 3
        assert seq.max() == 1
        np.testing.assert_array_equal(seq.cumsum(), [1, 1, 2, 3])

    def test_counts_not_shadowed(self):
        seq = BinarySequence("1011")
        assert seq.ones == 3 and seq.zeros == 1


class TestUfuncOperandOrder:
    def test_np_add_signal_lhs_preserves_noise(self):
        es = ("ElectricalSignal", [1.0, 2.0], {"noise": [0.1, 0.2]})
        out = _both(np.add, es, np.ones(2))
        np.testing.assert_allclose(out.signal, [2.0, 3.0])
        np.testing.assert_allclose(out.noise, [0.1, 0.2])
        out2 = _both(np.add, np.ones(2), es)
        np.testing.assert_allclose(out2.signal, out.signal)
        np.testing.assert_allclose(out2.noise, out.noise)

    def test_np_subtract_signal_lhs(self):
        out = _both(np.subtract, ("ElectricalSignal", [3.0, 4.0],
                                  {"noise": [0.1, 0.2]}), np.ones(2))
        np.testing.assert_allclose(out.signal, [2.0, 3.0])
        np.testing.assert_allclose(out.noise, [0.1, 0.2])

    def test_np_multiply_signal_lhs_bilinear(self):
        es = ElectricalSignal([1.0, 2.0], noise=[0.5, 0.5])
        out = _both(np.multiply, ("ElectricalSignal", [1.0, 2.0],
                                  {"noise": [0.5, 0.5]}), np.full(2, 2.0))
        ref = es * np.full(2, 2.0)
        np.testing.assert_allclose(out.signal, ref.signal)
        np.testing.assert_allclose(out.noise, ref.noise)

    def test_np_add_sequence_lhs_concatenates(self):
        out = _both(np.add, ("BinarySequence", [1, 0, 1]),
                    np.array([0, 1, 0]))
        np.testing.assert_array_equal(out.data, [1, 0, 1, 0, 1, 0])
        out2 = _both(np.add, np.array([0, 1, 0]),
                     ("BinarySequence", [1, 0, 1]))
        np.testing.assert_array_equal(out2.data, [0, 1, 0, 1, 0, 1])

    def test_np_multiply_sequence_lhs_tiles(self):
        out = _both(np.multiply, ("BinarySequence", [1, 0]), 2)
        np.testing.assert_array_equal(out.data, [1, 0, 1, 0])
        out2 = _both(np.multiply, 2, ("BinarySequence", [1, 0]))
        np.testing.assert_array_equal(out2.data, [1, 0, 1, 0])

    def test_ne_elementwise(self):
        a = ElectricalSignal([1.0, 2.0, 3.0])
        b = ElectricalSignal([1.0, 2.0, 4.0])
        ne = a != b
        np.testing.assert_array_equal(np.asarray(ne), [False, False, True])


def test_rewrap_stays_on_the_operand_device():
    """With no device named, ``gv`` sends host data to the card; a result
    re-wrapped from a CPU signal stays on the CPU all the same."""
    sig = ElectricalSignal(torch.tensor([3.0, -4.0]))
    osig = OpticalSignal(torch.ones(2, 4, dtype=torch.complex128))
    gv.default()  # no device named: host data would go to the card
    for out in (np.abs(sig), np.roll(sig, 1), np.exp(osig),
                np.add(np.ones(2), sig)):
        assert out.device.type == "cpu"
    assert np.abs(sig).signal.dtype == torch.float32  # NumPy keeps it
