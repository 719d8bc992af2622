"""Host-side NumPy helpers copied from ``opticomlib_tpu.utils.analysis``:
dB conversions (reference utils.py:343-483), ``Q``, ``si``,
``shortest_int``, ``dec2bin``, ``str2array`` and the ``tic``/``toc`` timer
behind the devices' ``execution_time`` (reference utils.py:113-340, 486-593,
914-965, 1497-1537)."""
from __future__ import annotations

import numbers
import re
import time

import numpy as np
from scipy.special import erfc

__all__ = ["db", "dbm", "idb", "idbm", "Q", "si", "shortest_int", "dec2bin",
           "dec2bin_array", "str2array", "tic", "toc"]


def _is_real(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def _is_integer(x) -> bool:
    return isinstance(x, numbers.Integral) and not isinstance(x, bool)


def _is_arraylike(x) -> bool:
    if isinstance(x, (np.ndarray, list, tuple)):
        return True
    return hasattr(x, "__array__") and hasattr(x, "shape")


def db(x):
    """Linear -> dB: ``10*log10(x)``."""
    x = np.asarray(x, dtype=float) if _is_arraylike(x) else x
    if np.any(np.asarray(x) < 0):
        raise ValueError("Negative values not allowed for dB conversion.")
    return 10 * np.log10(x)


def dbm(x):
    """Power [W] -> dBm: ``10*log10(x/1mW)``."""
    x = np.asarray(x, dtype=float) if _is_arraylike(x) else x
    if np.any(np.asarray(x) < 0):
        raise ValueError("Negative values not allowed for dBm conversion.")
    return 10 * np.log10(np.asarray(x) * 1e3)


def idb(x):
    """dB -> linear: ``10**(x/10)``."""
    return 10 ** (np.asarray(x) / 10) if _is_arraylike(x) else 10 ** (x / 10)


def idbm(x):
    """dBm -> power [W]: ``1e-3 * 10**(x/10)``."""
    return 1e-3 * idb(x)


def Q(x):
    """Gaussian tail probability ``Q(x) = 0.5*erfc(x/sqrt(2))``."""
    return 0.5 * erfc(np.asarray(x) / np.sqrt(2))


_SI_PREFIXES = [
    (1e12, 1e-12, "T"), (1e9, 1e-9, "G"), (1e6, 1e-6, "M"), (1e3, 1e-3, "k"),
    (1.0, 1.0, ""), (1e-3, 1e3, "m"), (1e-6, 1e6, "μ"), (1e-9, 1e9, "n"),
    (1e-12, 1e12, "p"), (1e-15, 1e15, "f"),
]


def si(x, unit: str = "s", k: int = 1) -> str:
    """Engineering-notation formatter, e.g. ``si(1e9, 'Hz') -> '1.0 GHz'``."""
    if x == 0 or not np.isfinite(x):
        return f"{x:.{k}f} {unit}"
    mag = abs(x)
    for thresh, scale, prefix in _SI_PREFIXES:
        if mag >= thresh:
            return f"{x * scale:.{k}f} {prefix}{unit}"
    return f"{x:.{k}f} {unit}"


def shortest_int(x: np.ndarray, percent: float = 50):
    """Shortest interval containing ``percent``% of the samples of ``x``.

    Same estimator as the reference (sorted order statistics, lag-window of
    minimal width; ties resolved by the mean index).
    """
    if not _is_arraylike(x):
        raise TypeError("`x` must be an array_like.")
    if not _is_real(percent) or percent <= 0 or percent > 100:
        raise ValueError("`percent` must be a real number between (0, 100].")

    x = np.sort(np.asarray(x).real.ravel())
    lag = int(len(x) * percent / 100)
    if lag < 1:
        raise ValueError(
            f"Computed lag ({lag}) must be at least 1; percent ({percent}%) "
            f"too small for length {len(x)}.")
    diff = x[lag:] - x[:-lag]
    i = np.where(np.abs(diff - diff.min()) < 1e-10)[0]
    i = int(np.mean(i)) if len(i) > 1 else int(i[0])
    return np.array((x[i], x[i + lag]))


def dec2bin(num: int, digits: int = 8) -> np.ndarray:
    """Integer -> fixed-width MSB-first bit vector (uint8)."""
    if not _is_integer(num):
        raise ValueError("`num` must be an integer number.")
    num = int(num)
    if num < 0:
        # the reference's while-loop silently returns all zeros here; an
        # unsigned encoder has no valid answer, so fail loudly instead
        raise ValueError("`num` must be non-negative.")
    if num > 2**digits - 1:
        raise ValueError(
            f"The number is too large to be represented with {digits} bits.")
    out = np.zeros(digits, np.uint8)
    out[:] = (num >> np.arange(digits - 1, -1, -1)) & 1
    return out


def dec2bin_array(nums: np.ndarray, digits: int = 8) -> np.ndarray:
    """Vectorized :func:`dec2bin`: (M,) ints -> (M, digits) uint8 matrix."""
    nums = np.asarray(nums, dtype=np.int64)
    if np.any(nums < 0):
        raise ValueError("All numbers must be non-negative.")
    if np.any(nums > 2**digits - 1):
        raise ValueError(
            f"Some numbers are too large to be represented with {digits} bits.")
    shifts = np.arange(digits - 1, -1, -1)
    return ((nums[..., None] >> shifts) & 1).astype(np.uint8)


def _str_dtype(string: str):
    if re.match(r"^[0-1,;\s]+$", string):
        return bool
    if re.match(r"^[0-9,;\-\+\s]+$", string):
        return int
    if re.match(r"^[0-9,;.\+\-\s]+$", string):
        return float
    if re.match(r"^[0-9,;.\+\-\sjie]+$", string):
        return complex
    return None


def str2array(string: str, dtype=None) -> np.ndarray:
    """Parse ``"1 0 1; 0 1 0"`` / ``"1+2j, 3-4i"`` style strings to ndarray.

    Rows are separated by ``;``, elements by spaces or commas.  The dtype is
    inferred (bool < int < float < complex) unless given explicitly.
    """
    if not isinstance(string, str):
        raise TypeError("`string` must be a string.")
    if dtype is None:
        dtype = _str_dtype(string)
        if dtype is None:
            raise ValueError(f"Can't parse string {string!r} to an array.")

    rows = [r for r in string.split(";") if r.strip()]
    parsed = []
    for row in rows:
        elems = [e for e in re.split(r"[,\s]+", row.strip()) if e]
        if dtype is complex:
            parsed.append([complex(e.replace("i", "j")) for e in elems])
        elif dtype is bool:
            # binary strings split per-character: "0100 11" -> 6 bits
            # (reference utils.py str2array: '1 0 1 10' -> [1,0,1,1,0])
            chars = "".join(elems)
            if any(ch not in "01" for ch in chars):
                raise ValueError("Binary string may contain only 0s and 1s.")
            parsed.append([int(ch) for ch in chars])
        else:
            parsed.append([dtype(e) for e in elems])
    out = np.array(parsed, dtype=dtype)
    return out[0] if out.shape[0] == 1 else out


class _TimerStack:
    """Stack-based wall-clock timer powering the per-device
    ``execution_time`` metadata (reference utils.py:293-340)."""

    def __init__(self) -> None:
        self._stack = []

    def tic(self) -> None:
        self._stack.append(time.perf_counter())

    def toc(self) -> float:
        if not self._stack:
            raise RuntimeError("toc() called without matching tic().")
        return time.perf_counter() - self._stack.pop()


_timer = _TimerStack()


def tic() -> None:
    _timer.tic()


def toc() -> float:
    return _timer.toc()
