"""Signal types with the signal/noise dual-track algebra (port of
``opticomlib_tpu.signals``; reference typing.py:402-2427).

* :class:`BinarySequence` holds host ``uint8`` bits, as in the JAX package.
* :class:`ElectricalSignal` and :class:`OpticalSignal` are plain classes over
  torch tensors.  ``signal`` and ``noise`` live on one device: a tensor
  given to a constructor keeps its device, host data (NumPy arrays, lists,
  scalars, strings) goes to ``gv``'s device (the card by default,
  ``gv(device="cpu")`` for the CPU).  Waveform-sized results stay tensors on that device;
  reductions (``power``, ``mean``, ``std``) and ``to_numpy`` come back to
  the host.  The payload of ``FIBER(mesh=...)``'s output is a
  :class:`~opticomlib_tpu_torch.parallel.fiber.ShardedField`: each rank
  holds its block, and the next ``FIBER(mesh=...)`` takes it where it lies.
  Everything else (the signal algebra, the other devices, ``to_numpy``)
  sees the whole field, gathered onto each rank's device: a collective that
  every rank makes, as SPMD code makes every call.
* "No noise" is the absorbing :data:`NULL` sentinel (reference
  typing.py:56-93): ``x + NULL == x``, ``x * NULL == NULL``, so noiseless
  paths cost nothing.

Noise propagation identities (reference typing.py:1337-1344, 1400-1419):

* ``(s1,n1) * (s2,n2) -> (s1*s2, s1*n2 + n1*s2 + n1*n2)``
* ``(s,n) ** 2        -> (s**2,  2*s*n + n**2)``

These let the photodetector split signal-ASE / ASE-ASE beat noise
analytically (reference devices.py:1460-1479).

Type promotion follows NumPy's: operands from host data are wrapped as 1-D
tensors, so ``complex64 * float64`` gives ``complex128`` as it does for two
NumPy arrays, and a Python scalar divisor keeps the signal's precision as
NumPy 2 keeps it.

NumPy protocol (reference typing.py:518-692, 1224-1306): ``np.add``,
``np.subtract`` and ``np.multiply`` keep the classes' algebra (sequence
concatenation and repetition; the signal/noise bilinear algebra) whichever
side the object is on; other ufuncs and NumPy functions act on the bits or
on ``signal + noise`` (a host copy) and re-wrap shape-compatible results,
a signal's on the operand's device.  Drawing (``plot``, ``psd``,
``plot_eye``, ``grid``, ``legend``, ``show``) is host Matplotlib, imported
when called.
"""
from __future__ import annotations

from typing import Iterable, Literal, Optional, Union

import numpy as np
import torch

from .params import current_device, gv
from .utils.analysis import dbm, si, str2array

__all__ = [
    "NULL", "NULLType",
    "BinarySequence", "ElectricalSignal", "OpticalSignal",
    "binary_sequence", "electrical_signal", "optical_signal",
    "Array_Like", "RealNumber", "ComplexNumber",
]

Array_Like = (list, tuple, np.ndarray, torch.Tensor)
RealNumber = (int, float, np.integer, np.floating)
ComplexNumber = RealNumber + (complex, np.complexfloating)


# ---------------------------------------------------------------------------
# NULL sentinel (reference typing.py:56-93)
# ---------------------------------------------------------------------------
class NULLType:
    """Absorbing zero-like sentinel for 'no noise'.

    ``x + NULL -> x``; ``x * NULL -> NULL``; ``-NULL -> NULL``.  Singleton.
    """

    _instance = None
    __array_ufunc__ = None  # force numpy to defer to our reflected ops
    __array_priority__ = 1000

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NULL"

    def __bool__(self):
        return False

    # additive identity
    def __add__(self, other):
        return other

    __radd__ = __add__

    def __sub__(self, other):
        return -other

    def __rsub__(self, other):
        return other

    def __neg__(self):
        return self

    # multiplicative absorber
    def __mul__(self, other):
        return self

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self

    def __pow__(self, other):
        return self

    def conj(self):
        return self

    def __getitem__(self, key):
        return self

    def sum(self, axis=None):
        return self


NULL = NULLType()


def _has_noise(noise) -> bool:
    return noise is not NULL and noise is not None


def _as_noise(noise):
    return noise if _has_noise(noise) else NULL


def _is_sharded(value) -> bool:
    """Whether ``value`` is a field spread over a mesh of ranks (the
    ``ShardedField`` of :mod:`opticomlib_tpu_torch.parallel.fiber`, known
    here only by its ``is_sharded`` mark)."""
    return getattr(value, "is_sharded", False)


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """A NumPy dtype (or a torch dtype, or ``None``) as a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _astensor(value, dtype=None, device=None) -> torch.Tensor:
    """A tensor from a tensor (its device kept unless ``device`` is given),
    or from host data (str / scalars / array-likes), placed on ``device``
    (default: ``gv``'s device)."""
    dtype = torch_dtype(dtype)
    if _is_sharded(value):
        # the output of FIBER(mesh=): it stays on its ranks, for the next
        # FIBER(mesh=) or a gather (``to_numpy``, a collective)
        return value
    if isinstance(value, torch.Tensor):
        out = value if dtype is None else value.to(dtype)
        return out if device is None else out.to(device)
    if isinstance(value, str):
        value = str2array(value)
    arr = np.asarray(value)
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"can't make a signal of {arr.dtype} data")
    out = torch.as_tensor(arr, device=current_device() if device is None
                          else device)
    return out if dtype is None else out.to(dtype)


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


def _conj(x: torch.Tensor) -> torch.Tensor:
    return torch.conj_physical(x) if x.is_complex() else x


# ---------------------------------------------------------------------------
# BinarySequence (reference typing.py:402-1009)
# ---------------------------------------------------------------------------
class BinarySequence:
    """1-D bit container (host ``uint8``).

    Accepts strings (``"1 0 1"``, ``"101"``, comma-separated), iterables,
    arrays and tensors of 0/1.  Supports bitwise operators, concatenation
    (``+``), repetition (``*``), slicing, and Hamming distance — behavioral
    parity with reference typing.py:402-1009.
    """

    def __init__(self, data: Union[str, Iterable, "BinarySequence"]):
        if isinstance(data, BinarySequence):
            arr = np.array(data.data, copy=True)
        elif isinstance(data, str):
            s = data.replace(",", " ").replace(";", " ").strip()
            if " " not in s:
                s = " ".join(s)  # "101" -> "1 0 1"
            arr = str2array(s, bool) if s else np.array([], dtype=bool)
        elif isinstance(data, torch.Tensor):
            arr = data.detach().cpu().numpy()
        else:
            arr = np.asarray(data)
        arr = np.asarray(arr)
        if arr.ndim == 0:
            arr = arr[np.newaxis]
        if arr.ndim != 1:
            raise ValueError("Binary sequence must be 1-dimensional.")
        if arr.dtype != np.uint8:
            vals = np.asarray(arr)
            if not np.all((vals == 0) | (vals == 1)):
                raise ValueError(
                    "The binary sequence must contain only 0s and 1s!")
            arr = vals.astype(np.uint8)
        self.data = arr
        self.execution_time: float = 0.0

    # -- basic protocol --
    def __len__(self):
        return self.data.size

    def __iter__(self):
        return iter(self.data)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data, dtype=dtype)

    def __getattr__(self, name):
        # delegate array-like attribute access to the underlying ndarray
        # (reference typing.py:543-560): seq.max(), seq.cumsum(), ...
        if not name.startswith("_") and hasattr(np.ndarray, name):
            return getattr(np.asarray(
                object.__getattribute__(self, "data")), name)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """np.add/np.multiply keep sequence semantics (concatenate/tile)
        whichever side the sequence is on; other ufuncs apply to the bits
        and re-wrap binary results (reference typing.py:600-645)."""
        out = _operator(BinarySequence, _SEQUENCE_OPS, ufunc, method, inputs,
                        kwargs)
        if out is not None:
            return out
        new_inputs = [inp.__array__() if isinstance(inp, BinarySequence)
                      else inp for inp in inputs]
        return _rewrap_bits(getattr(ufunc, method)(*new_inputs, **kwargs))

    def __array_function__(self, func, types, args, kwargs):
        """Higher-level NumPy functions (np.concatenate, np.roll, ...)
        apply to the bits and re-wrap binary results
        (reference typing.py:647-692)."""
        return _rewrap_bits(func(*_to_arrays(args, BinarySequence),
                                 **_to_arrays(kwargs, BinarySequence)))

    def to_numpy(self, dtype=None):
        return np.asarray(self.data, dtype=dtype)

    def __getitem__(self, key):
        out = self.data[key]
        if np.ndim(out) == 0:
            return int(out)
        return BinarySequence(out)

    def __repr__(self):
        return f"binary_sequence({self.data})"

    def __str__(self):
        ones = int(self.data.sum())
        n = self.data.size
        return (
            f"\nbinary_sequence: {self.data}\n"
            f"\tlen: {n}\n\tones: {ones}\n\tzeros: {n - ones}\n")

    def print(self, msg: Optional[str] = None):
        if msg:
            print(msg)
        print(self)
        return self

    # -- properties --
    @property
    def size(self) -> int:
        return int(self.data.size)

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def type(self):
        return type(self)

    @property
    def sizeof(self) -> int:
        """Bytes held by the bits (the reference counts the whole object
        with pympler, typing.py:824-830)."""
        return int(self.data.nbytes)

    @property
    def ones(self) -> int:
        """Number of ones (reference typing.py:797-801)."""
        return int(np.sum(self.data == 1))

    @property
    def zeros(self) -> int:
        """Number of zeros (reference typing.py:804-808)."""
        return int(np.sum(self.data == 0))

    # -- operators --
    def _coerce(self, other) -> "BinarySequence":
        return other if isinstance(other, BinarySequence) \
            else BinarySequence(other)

    def __add__(self, other):  # concatenation (reference semantics)
        other = self._coerce(other)
        return BinarySequence(np.concatenate([self.data, other.data]))

    def __radd__(self, other):
        other = self._coerce(other)
        return BinarySequence(np.concatenate([other.data, self.data]))

    def __mul__(self, n: int):  # repetition
        if not isinstance(n, (int, np.integer)):
            raise TypeError("Can only repeat a binary sequence by an integer.")
        return BinarySequence(np.tile(self.data, int(n)))

    __rmul__ = __mul__

    def __invert__(self):
        return BinarySequence(1 - self.data)

    def __and__(self, other):
        return BinarySequence(self.data & self._coerce(other).data)

    def __or__(self, other):
        return BinarySequence(self.data | self._coerce(other).data)

    def __xor__(self, other):
        return BinarySequence(self.data ^ self._coerce(other).data)

    def __eq__(self, other):
        return self.data == self._coerce(other).data

    def __ne__(self, other):
        return self.data != self._coerce(other).data

    def __hash__(self):
        return id(self)

    # -- methods --
    def hamming_distance(self, other) -> int:
        other = self._coerce(other)
        return int(np.sum(self.data != other.data))

    def flip(self):
        """Invert the binary sequence; same as ``~`` (reference
        typing.py:938-948)."""
        return ~self

    def dac(self, **kwargs):
        """Shortcut to :func:`opticomlib_tpu_torch.devices.DAC`."""
        from .devices import DAC
        return DAC(self, **kwargs)

    @staticmethod
    def prbs(order: int, len: Optional[int] = None,
             seed: Optional[int] = None):
        from .ops.prbs import prbs as _prbs
        bits, _ = _prbs(order, length=len, seed=seed)
        return BinarySequence(bits)

    def plot(self, *args, **kwargs):
        import matplotlib.pyplot as plt
        n = kwargs.pop("n", self.size)
        plt.step(np.arange(n), self.data[:n], *args, where="post", **kwargs)
        return self

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()
        return self


_SEQUENCE_OPS = {np.add: ("__add__", "__radd__"),
                 np.multiply: ("__mul__", "__rmul__")}
_SIGNAL_OPS = {**_SEQUENCE_OPS, np.subtract: ("__sub__", "__rsub__")}


def _operator(cls, ops, ufunc, method, inputs, kwargs):
    """A ufunc of ``ops`` called on two operands, one of them a ``cls``, as
    that class's operator (``np.add(a, x)`` is ``x.__radd__(a)``); None for
    any other call."""
    if method != "__call__" or kwargs.get("out") or ufunc not in ops:
        return None
    fwd, rev = ops[ufunc]
    lhs, rhs = inputs
    if isinstance(lhs, cls):
        return getattr(lhs, fwd)(rhs)
    return getattr(rhs, rev)(lhs)


def _to_arrays(obj, cls):
    """``obj`` with every ``cls`` instance in it (through lists, tuples and
    dicts) replaced by its NumPy array."""
    if isinstance(obj, cls):
        return obj.__array__()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_arrays(i, cls) for i in obj)
    if isinstance(obj, dict):
        return {k: _to_arrays(v, cls) for k, v in obj.items()}
    return obj


def _rewrap_bits(result):
    """A NumPy result as a :class:`BinarySequence` where it is one (1-D,
    0s and 1s), else as it is."""
    if isinstance(result, np.ndarray):
        try:
            return BinarySequence(result)
        except (ValueError, TypeError):
            pass
    return result


# ---------------------------------------------------------------------------
# ElectricalSignal (reference typing.py:1022-2090)
# ---------------------------------------------------------------------------
class ElectricalSignal:
    """Complex baseband signal with a separately-tracked noise tensor."""

    n_pol = 1

    def __init__(self, signal, noise=NULL, dtype=None):
        if isinstance(signal, ElectricalSignal):
            sig, noi = signal.signal, signal.noise
            if _has_noise(noise):
                noi = noi + _astensor(noise, dtype, sig.device)
        else:
            sig = _astensor(signal, dtype)
            noi = (_astensor(noise, dtype, sig.device) if _has_noise(noise)
                   else NULL)
        if sig.ndim == 0:
            sig = sig.reshape(1)
        if _has_noise(noi) and noi.shape != sig.shape:
            if noi.ndim == 0:  # scalar noise broadcasts over the signal
                noi = noi.expand(sig.shape).clone()
            else:
                raise ValueError(
                    f"signal {tuple(sig.shape)} and noise "
                    f"{tuple(noi.shape)} must have the same shape")
        self.signal = sig
        self.noise = _as_noise(noi)
        self.execution_time: float = 0.0

    # -- representation --
    def __str__(self, title: Optional[str] = None):
        title = title or self.__class__.__name__
        head = 3 * "*" + f"    {title}    " + 3 * "*"
        sub = len(head) * "-"
        np.set_printoptions(precision=3, threshold=20)
        pw_sig = float(np.sum(self.power("W", "signal")))
        pw_noi = float(np.sum(self.power("W", "noise")))
        pw_all = float(np.sum(self.power("W", "all")))

        def _dbm(p):
            return dbm(p) if p > 0 else -np.inf

        noise = (self.noise.cpu().numpy() if _has_noise(self.noise)
                 else self.noise)
        return (
            f"\n{sub}\n{head}\n{sub}\n"
            f"   signal:     {self.signal.cpu().numpy()} "
            f"(shape: {self.shape})\n"
            f"   noise:      {noise}\n"
            f"   pow_signal: {si(pw_sig, 'W', 1)} ({_dbm(pw_sig):.1f} dBm)\n"
            f"   pow_noise:  {si(pw_noi, 'W', 1)} ({_dbm(pw_noi):.1f} dBm)\n"
            f"   pow_total:  {si(pw_all, 'W', 1)} ({_dbm(pw_all):.1f} dBm)\n"
            f"   len:        {self.size}\n"
            f"   elem_type:  {self.dtype}\n"
            f"   device:     {self.device}\n"
            f"   time:       {si(self.execution_time, 's', 2)}\n")

    def __repr__(self):
        if _is_sharded(self.signal):
            return f"{self.__class__.__name__}({self.signal!r})"
        np.set_printoptions(precision=3, threshold=20)
        return f"{self.__class__.__name__}({self.signal.cpu().numpy()})"

    def print(self, msg: Optional[str] = None):
        print(self.__str__(msg))
        return self

    # -- conversion --
    def _total(self) -> torch.Tensor:
        return self.signal + self.noise

    def to_numpy(self, dtype=None, copy: bool = False) -> np.ndarray:
        """``signal + noise`` as a host ndarray (of a sharded payload: the
        gathered field, a collective every rank calls)."""
        if _is_sharded(self.signal):
            return np.array(self.signal.gather(), dtype=dtype,
                            copy=copy or None)
        data = self._total().detach().resolve_conj().cpu().numpy()
        return np.array(data, dtype=dtype, copy=copy or None)

    def __array__(self, dtype=None, copy=None):
        return self.to_numpy(dtype)

    # -- NumPy protocol integration (reference typing.py:1224-1306) --
    def _wrap_array_result(self, result):
        """Re-wrap an ndarray result in the signal class, on this signal's
        device, when the shape is compatible (reference
        typing.py:1268-1275): 1-D for electrical_signal, 1-D/2-D for
        optical_signal."""
        if isinstance(result, np.ndarray):
            if type(self) is ElectricalSignal and result.ndim == 1:
                return ElectricalSignal(_astensor(result, device=self.device))
            if isinstance(self, OpticalSignal) and result.ndim in (1, 2):
                return type(self)(_astensor(result, device=self.device))
        return result

    def __getattr__(self, name):
        # ndarray attribute delegation (reference typing.py:1231-1238):
        # sig.var(), sig.max(), sig.cumsum(), sig.T ... act on signal+noise
        # (on a host copy)
        if not name.startswith("_") and hasattr(np.ndarray, name):
            return getattr(self.to_numpy(), name)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """np.add/np.subtract/np.multiply keep the signal/noise bilinear
        algebra whichever side the signal is on; other ufuncs act on
        ``signal + noise`` and re-wrap shape-compatible results (reference
        typing.py:1241-1276)."""
        out = _operator(ElectricalSignal, _SIGNAL_OPS, ufunc, method, inputs,
                        kwargs)
        if out is not None:
            return out
        new_inputs = [inp.__array__() if isinstance(inp, ElectricalSignal)
                      else inp for inp in inputs]
        return self._wrap_array_result(
            getattr(ufunc, method)(*new_inputs, **kwargs))

    def __array_function__(self, func, types, args, kwargs):
        """Higher-level NumPy functions (np.concatenate, np.convolve,
        np.fft.fft, ...) act on ``signal + noise`` and re-wrap
        shape-compatible results (reference typing.py:1278-1306)."""
        return self._wrap_array_result(
            func(*_to_arrays(args, ElectricalSignal),
                 **_to_arrays(kwargs, ElectricalSignal)))

    # -- parsing helper --
    def _parse(self, other):
        if isinstance(other, ElectricalSignal):
            return other, True
        return self.__class__(_astensor(other, device=self.device)), False

    # -- arithmetic with noise propagation --
    def __add__(self, other):
        other, _ = self._parse(other)
        return self.__class__(self.signal + other.signal,
                              self.noise + other.noise)

    __radd__ = __add__

    def __neg__(self):
        return self.__class__(-self.signal, -self.noise)

    def __sub__(self, other):
        other, _ = self._parse(other)
        return self + (-other)

    def __rsub__(self, other):
        other, _ = self._parse(other)
        return (-self) + other

    def __mul__(self, other):
        other, _ = self._parse(other)
        sig = self.signal * other.signal
        noi = (self.signal * other.noise + self.noise * other.signal
               + self.noise * other.noise)
        return self.__class__(sig, noi)

    __rmul__ = __mul__

    def __truediv__(self, number):
        if not isinstance(number, ComplexNumber):
            raise TypeError(
                f"Can't divide {self.__class__.__name__} by type "
                f"{type(number)}")
        if number == 0:
            raise ZeroDivisionError(
                f"Can't divide {self.__class__.__name__} by zero")
        number = number.item() if isinstance(number, np.generic) else number
        return self.__class__(self.signal / number, self.noise / number)

    def __floordiv__(self, other):
        x = self / other
        noi = torch.floor(x.noise) if _has_noise(x.noise) else NULL
        return self.__class__(torch.floor(x.signal), noi)

    def __pow__(self, other):
        if not isinstance(other, RealNumber):
            raise TypeError(
                f"Can't exponentiate {self.__class__.__name__} by type "
                f"{type(other)}")
        if other == 0:
            return self.__class__(torch.ones_like(self.signal), NULL)
        if other == 1:
            return self.__class__(self.signal, self.noise)
        if other == 2:
            s, n = self.signal, self.noise
            noi = 2 * s * n + n * n if _has_noise(n) else NULL
            return self.__class__(s * s, noi)
        return self.__class__(self._total() ** other, NULL)

    def _compare(self, other, op):
        other, _ = self._parse(other)
        res = op(_real(self._total()), _real(other._total()))
        return BinarySequence(res.to(torch.uint8).cpu().numpy())

    def __gt__(self, other):
        return self._compare(other, torch.gt)

    def __lt__(self, other):
        return self._compare(other, torch.lt)

    def __eq__(self, other):
        other, _ = self._parse(other)
        return self._total() == other._total()

    def __ne__(self, other):
        other, _ = self._parse(other)
        return self._total() != other._total()

    def __hash__(self):
        return id(self)

    def __getitem__(self, key):
        if isinstance(key, (slice, int, tuple, np.ndarray, torch.Tensor)):
            noi = self.noise[key] if _has_noise(self.noise) else NULL
            return self.__class__(self.signal[key], noi)
        raise TypeError(f"Invalid argument type {type(key)}")

    def __len__(self):
        return int(self.signal.shape[-1])

    def __iter__(self):
        """Iterate over signal+noise samples (reference
        typing.py:1219-1221)."""
        return iter(self.to_numpy())

    # -- FFT domain switch (reference typing.py:1421-1462) --
    def __call__(self, domain: Literal["t", "w", "f"], shift: bool = False):
        if domain in ("w", "f"):
            fn, sh = torch.fft.fft, torch.fft.fftshift
        elif domain == "t":
            fn, sh = torch.fft.ifft, torch.fft.ifftshift
        else:
            raise ValueError(
                "`domain` must be one of the following values ('t', 'w', "
                "'f')")

        def one(x):
            y = fn(x, dim=-1)
            return sh(y, dim=-1) if shift else y

        noi = one(self.noise) if _has_noise(self.noise) else NULL
        return self.__class__(one(self.signal), noi)

    # -- properties --
    @property
    def index(self) -> np.ndarray:
        """Sample index vector 0..n-1 (reference typing.py:1466-1468)."""
        return np.arange(self.size)

    @property
    def size(self) -> int:
        return int(self.signal.numel())

    @property
    def shape(self):
        return tuple(self.signal.shape)

    @property
    def ndim(self):
        return self.signal.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.signal.dtype

    @property
    def device(self) -> torch.device:
        return self.signal.device

    @property
    def real(self):
        """Real parts of signal and noise, wrapped (reference
        typing.py:1477)."""
        noi = _real(self.noise) if _has_noise(self.noise) else NULL
        return self.__class__(_real(self.signal), noi)

    @property
    def imag(self):
        def im(x):
            return x.imag if x.is_complex() else torch.zeros_like(x)
        noi = im(self.noise) if _has_noise(self.noise) else NULL
        return self.__class__(im(self.signal), noi)

    @property
    def type(self):
        return type(self)

    @property
    def sizeof(self) -> int:
        """Bytes held by the signal and noise tensors (the reference counts
        the whole object with pympler, typing.py:1494-1499)."""
        return sum(int(x.numel() * x.element_size())
                   for x in (self.signal, self.noise) if _has_noise(x))

    @property
    def fs(self) -> float:
        return gv.fs

    @property
    def sps(self) -> int:
        return gv.sps

    @property
    def dt(self) -> float:
        return gv.dt

    @property
    def t(self) -> np.ndarray:
        return np.arange(self.signal.shape[-1]) * gv.dt

    # -- spectra axes --
    def w(self, shift: bool = False) -> np.ndarray:
        w = np.fft.fftfreq(self.signal.shape[-1], gv.dt) * 2 * np.pi
        return np.fft.fftshift(w) if shift else w

    def f(self, shift: bool = False) -> np.ndarray:
        return self.w(shift) / (2 * np.pi)

    # -- math --
    def conj(self):
        noi = _conj(self.noise) if _has_noise(self.noise) else NULL
        return self.__class__(_conj(self.signal), noi)

    def sum(self, axis: Optional[int] = None):
        def s(x):
            return x.sum() if axis is None else x.sum(dim=axis)
        noi = s(self.noise) if _has_noise(self.noise) else NULL
        return self.__class__(s(self.signal), noi)

    def mean(self, axis: int = -1):
        return np.mean(self.to_numpy(), axis=axis)

    def std(self, axis: int = -1):
        return np.std(self.to_numpy(), axis=axis)

    def abs(self, of: Literal["signal", "noise", "all"] = "all"):
        """``|signal|``, ``|noise|`` or ``|signal + noise|`` as a tensor on
        the signal's device."""
        if not isinstance(of, str):
            raise TypeError("`of` must be a string.")
        of = of.lower()
        if of == "signal":
            return torch.abs(self.signal)
        if of == "noise":
            if not _has_noise(self.noise):
                return torch.zeros_like(_real(self.signal))
            return torch.abs(self.noise)
        if of == "all":
            return torch.abs(self._total())
        raise ValueError(
            '`of` must be one of the following values ("signal", "noise", '
            '"all")')

    def power(self, unit: Literal["W", "dBm"] = "W",
              of: Literal["signal", "noise", "all"] = "all"):
        """Mean power along the last axis, on the host (a float64 NumPy
        value, one per polarization)."""
        a = self.abs(of).to(torch.float64)
        p = (a * a).mean(dim=-1).cpu().numpy()
        p = p[()] if p.ndim == 0 else p
        if unit == "W":
            return p
        if unit.lower() == "dbm":
            return dbm(p)
        raise ValueError(
            '`unit` must be one of the following values ("W", "dBm")')

    def normalize(self, by: Literal["power", "amplitude"] = "power"):
        if by == "power":
            return self / float(np.sum(self.power("W", "signal")) ** 0.5)
        if by == "amplitude":
            return self / float(self.abs("signal").max())
        raise ValueError(
            '`by` must be one of the following values ("power", '
            '"amplitude")')

    def phase(self) -> np.ndarray:
        return np.unwrap(np.angle(self.to_numpy()))

    def apply(self, fn, *args, **kwargs):
        """Apply ``fn`` elementwise to signal (and noise if present)."""
        noi = (fn(self.noise, *args, **kwargs) if _has_noise(self.noise)
               else NULL)
        return self.__class__(fn(self.signal, *args, **kwargs), noi)

    def filter(self, h):
        """FIR filter, ``mode='same'``, applied to signal and noise
        (reference typing.py:1758-1780): real taps go through the
        ``fir_filter`` kernel, see
        :func:`opticomlib_tpu_torch.ops.pulses.fft_convolve_same`."""
        from .ops.pulses import fft_convolve_same
        sig = fft_convolve_same(self.signal, h)
        noi = (fft_convolve_same(self.noise, h) if _has_noise(self.noise)
               else NULL)
        return self.__class__(sig, noi)

    # -- host-side plotting --
    def plot(self, fmt="-", n: Optional[int] = None, xlabel=None, ylabel=None,
             grid: bool = False, hold: bool = True, show: bool = False,
             **kwargs):
        import matplotlib.pyplot as plt
        n = n if n is not None else self.size
        t = gv.t[:n] if gv.t.size >= n else np.arange(n) * self.dt
        y = np.asarray(self.to_numpy()).real
        y = y[..., :n] if y.ndim == 1 else y[..., :n].T
        if not hold:
            plt.figure()
        plt.plot(t * 1e9, y, fmt, **kwargs)
        plt.xlabel(xlabel or "Time [ns]")
        plt.ylabel(ylabel or "Amplitude [V]")
        if grid:
            plt.grid(alpha=0.3)
        if kwargs.get("label"):
            plt.legend()
        if show:
            plt.show()
        return self

    def psd(self, fmt="-", kind: str = "linear", n: Optional[int] = None,
            hold: bool = True, grid: bool = True, show: bool = False,
            **kwargs):
        import matplotlib.pyplot as plt
        from .utils.analysis import get_psd
        x = np.asarray(self.to_numpy())
        x = x if x.ndim == 1 else x[0]
        f, p = get_psd(x[:n] if n else x, fs=gv.fs * 1e-9)
        if kind == "log":
            p = 10 * np.log10(np.maximum(p, 1e-30) / 1e-3)
        if not hold:
            plt.figure()
        plt.plot(f, p, fmt, **kwargs)
        plt.xlabel("Frequency [GHz]")
        plt.ylabel("PSD" + (" [dBm]" if kind == "log" else " [W]"))
        if grid:
            plt.grid(alpha=0.3)
        if show:
            plt.show()
        return self

    def plot_eye(self, **kwargs):
        from .devices import GET_EYE
        eye_obj = GET_EYE(self, **kwargs)
        eye_obj.plot()
        return eye_obj

    def grid(self, **kwargs):
        """Add a grid to the current plot, chainable (reference
        typing.py:2043-2059)."""
        import matplotlib.pyplot as plt
        kwargs.setdefault("alpha", 0.3)
        plt.grid(**kwargs)
        return self

    def legend(self, *args, **kwargs):
        """Add a legend to the current plot, chainable (reference
        typing.py:2061-2078)."""
        import matplotlib.pyplot as plt
        plt.legend(*args, **kwargs)
        return self

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()
        return self


# ---------------------------------------------------------------------------
# OpticalSignal (reference typing.py:2103-2427)
# ---------------------------------------------------------------------------
class OpticalSignal(ElectricalSignal):
    """Optical field envelope with 1 or 2 polarization modes.

    ``n_pol=1`` -> 1-D tensor of shape (n,);  ``n_pol=2`` -> (2, n).
    Construction normalization follows reference typing.py:2124-2196:
    a 1-D input with ``n_pol=2`` is *duplicated* into both polarizations.
    """

    def __init__(self, signal, noise=NULL, n_pol: Optional[int] = None,
                 dtype=None):
        if isinstance(signal, ElectricalSignal):
            sig, noi = signal.signal, signal.noise
            if _has_noise(noise):
                noi = noi + _astensor(noise, dtype, sig.device)
        else:
            sig = _astensor(signal, dtype)
            noi = (_astensor(noise, dtype, sig.device) if _has_noise(noise)
                   else NULL)

        if _is_sharded(sig):
            if (not _has_noise(noi) and n_pol in (None, sig.ndim)
                    and (sig.ndim == 1 or sig.shape[0] == 2)):
                # FIBER(mesh=)'s output: kept as it lies, one row a
                # polarization
                self.n_pol = sig.ndim
                self.signal, self.noise = sig, NULL
                self.execution_time = 0.0
                return
            sig = sig.whole()   # anything else: the whole field

        if sig.ndim > 2 or (sig.ndim > 1 and sig.shape[0] > 2) \
                or sig.numel() < 1:
            raise ValueError(
                f"Signal must be a scalar, 1D or 2D array for "
                f"optical_signal, invalid shape {tuple(sig.shape)}")
        if n_pol is not None and n_pol not in (1, 2):
            raise ValueError("n_pol must be either 1 or 2")

        def _dup(x):
            return torch.stack([x, x])

        if sig.ndim == 0:
            sig = sig.reshape(1)
            if _has_noise(noi) and noi.ndim == 0:
                noi = noi.reshape(1)
            if n_pol == 2:
                sig = _dup(sig)
                if _has_noise(noi):
                    noi = _dup(noi)
            else:
                n_pol = 1
        elif sig.ndim == 1:
            if n_pol == 2:
                sig = _dup(sig)
                if _has_noise(noi):
                    noi = _dup(noi) if noi.ndim == 1 else noi
            else:
                n_pol = 1
        else:  # 2-D
            if sig.shape[0] == 1:
                if n_pol is None or n_pol == 2:
                    sig = sig.repeat(2, 1)
                    if _has_noise(noi):
                        noi = noi.repeat(2, 1)
                    n_pol = 2
                else:
                    sig = sig[0]
                    if _has_noise(noi):
                        noi = noi[0]
            else:
                if n_pol == 1:
                    sig = sig[0]
                    if _has_noise(noi):
                        noi = noi[0]
                else:
                    n_pol = 2

        self.n_pol = int(n_pol or (2 if sig.ndim == 2 else 1))
        super().__init__(sig, noi, dtype=dtype)

    def _parse(self, other):
        if isinstance(other, OpticalSignal):
            return other, True
        if isinstance(other, ElectricalSignal):
            return (OpticalSignal(other.signal, other.noise,
                                  n_pol=self.n_pol), True)
        return (OpticalSignal(_astensor(other, device=self.device),
                              n_pol=None), False)

    def __gt__(self, other):
        raise TypeError("'>' not supported for optical_signal")

    def __lt__(self, other):
        raise TypeError("'<' not supported for optical_signal")

    def __getitem__(self, key):
        noi = self.noise[key] if _has_noise(self.noise) else NULL
        sig = self.signal[key]
        if self.n_pol == 2 and isinstance(key, int):
            return OpticalSignal(sig, noi, n_pol=1)
        return self.__class__(sig, noi, n_pol=self.n_pol)

    @property
    def size(self) -> int:
        return int(self.signal.shape[-1])


# Reference-style lowercase aliases.
binary_sequence = BinarySequence
electrical_signal = ElectricalSignal
optical_signal = OpticalSignal
