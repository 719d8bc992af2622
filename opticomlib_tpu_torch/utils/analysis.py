"""Host-side NumPy helpers copied from ``opticomlib_tpu.utils.analysis``
(reference opticomlib/utils.py):

  db/dbm/idb/idbm           utils.py:343-483
  gaus, Q                   utils.py:486-593
  phase, tau_g, dispersion  utils.py:596-716
  bode                      utils.py:720-847
  rcos (spectrum)           utils.py:850-912
  si                        utils.py:914-965
  norm, nearest(_index)     utils.py:968-1072
  shortest_int              utils.py:1497-1537
  apply_optimized_gaussian_filter  utils.py:1541-1590
  phase_estimator           utils.py:1984-2045
  get_psd                   utils.py:2048-2080
  dec2bin, str2array        utils.py:113-264
  get_time, tic/toc         utils.py:268-340

Where the JAX functions accept a ``jax.Array`` these accept a tensor (on
any device), taken to the host first.  ``bode`` imports Matplotlib when it
is called.
"""
from __future__ import annotations

import numbers
import re
import time
import timeit as _timeit
from typing import Optional

import numpy as np
from scipy.constants import c, pi
from scipy.special import erfc

__all__ = ["db", "dbm", "idb", "idbm", "gaus", "Q", "phase", "tau_g",
           "dispersion", "rcos", "si", "norm", "nearest", "nearest_index",
           "shortest_int", "dec2bin", "dec2bin_array", "str2array", "tic",
           "toc", "get_time", "bode", "get_psd", "phase_estimator",
           "apply_optimized_gaussian_filter"]


def _host(x):
    """``x`` as host data: a tensor (on any device) as a NumPy array, other
    values as they are."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().resolve_conj().cpu().numpy()
    return x


def _is_numeric(x) -> bool:
    return isinstance(x, numbers.Number) and not isinstance(x, bool)


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


def gaus(x, mu: float = 0.0, std: float = 1.0):
    """Normal probability density function."""
    x = np.asarray(_host(x))
    return 1 / std / np.sqrt(2 * pi) * np.exp(-0.5 * ((x - mu) / std) ** 2)


def Q(x):
    """Gaussian tail probability ``Q(x) = 0.5*erfc(x/sqrt(2))``."""
    return 0.5 * erfc(np.asarray(_host(x)) / np.sqrt(2))


def phase(x: np.ndarray, zero_ref_index: Optional[int] = None) -> np.ndarray:
    """Unwrapped phase of ``x`` [rad], optionally re-referenced to one bin."""
    if not _is_arraylike(x):
        raise TypeError("The input value must be an array_like.")
    x = np.asarray(_host(x))
    ph = np.angle(x)
    offset = ph[zero_ref_index] if zero_ref_index is not None else 0.0
    return np.unwrap(ph) - offset


def tau_g(x: np.ndarray, fs: float) -> np.ndarray:
    """Group delay ``dphi/dw`` of a frequency response, in [ps]."""
    if not _is_arraylike(x):
        raise TypeError("The input value must be an array_like.")
    x = np.asarray(_host(x))
    dw = 2 * pi * fs / x.size
    ph = phase(x)
    return np.diff(ph, prepend=ph[0]) / dw * 1e12


def dispersion(x: np.ndarray, fs: float, f0: float) -> np.ndarray:
    """Cumulative chromatic dispersion of a frequency response, in [ps/nm]."""
    if not _is_arraylike(x):
        raise TypeError("The input value must be an array_like.")
    x = np.asarray(_host(x))
    f = np.fft.fftshift(np.fft.fftfreq(x.size, d=1 / fs))
    dlam = np.diff(c / (f + f0))[0] * 1e9
    tg = tau_g(x, fs)
    return np.diff(tg, prepend=tg[0]) / dlam


def rcos(x, alpha: float, T: float):
    """Raised-cosine spectrum function H(f) with roll-off ``alpha`` and
    period ``T`` evaluated at ``x`` (also the FBG's 'rcos' apodization)."""
    x = np.asarray(_host(x), dtype=float)
    out = np.zeros_like(x)
    ax = np.abs(x)
    flat = ax <= (1 - alpha) / (2 * T)
    rolloff = ((1 - alpha) / (2 * T) < ax) & (ax <= (1 + alpha) / (2 * T))
    out[flat] = 1.0
    if alpha > 0:
        out[rolloff] = 0.5 * (
            1 + np.cos(pi * T / alpha * (ax[rolloff] - (1 - alpha) / (2 * T)))
        )
    return out


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


def norm(x):
    """Normalize by the maximum value."""
    x = np.asarray(_host(x))
    return x / x.max()


def nearest(x, a):
    """Value(s) of ``x`` nearest to each element of ``a``."""
    x = np.asarray(_host(x))
    if _is_arraylike(a):
        a = np.asarray(_host(a))
        return x[np.argmin(np.abs(x[None, :] - a.reshape(-1, 1)), axis=1)]
    return x[np.argmin(np.abs(x - a))]


def nearest_index(x, a):
    """Index(es) in ``x`` of the value(s) nearest to each element of ``a``."""
    x = np.asarray(_host(x))
    if _is_arraylike(a):
        a = np.asarray(_host(a))
        return np.argmin(np.abs(x[None, :] - a.reshape(-1, 1)), axis=1)
    return int(np.argmin(np.abs(x - a)))


def shortest_int(x: np.ndarray, percent: float = 50):
    """Shortest interval containing ``percent``% of the samples of ``x``.

    Same estimator as the reference (sorted order statistics, lag-window of
    minimal width; ties resolved by the mean index).
    """
    if not _is_arraylike(x):
        raise TypeError("`x` must be an array_like.")
    if not _is_real(percent) or percent <= 0 or percent > 100:
        raise ValueError("`percent` must be a real number between (0, 100].")

    x = np.sort(np.asarray(_host(x)).real.ravel())
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


def get_time(fn, n: int = 1) -> float:
    """Average wall-clock execution time of ``fn`` over ``n`` runs [s]."""
    return _timeit.timeit(fn, number=n) / n


def get_psd(signal, fs: float, nperseg: Optional[int] = None):
    """Two-sided Welch PSD (spectrum scaling), fftshifted (reference
    utils.py:2048-2080: ``scipy.signal.welch`` with ``scaling='spectrum'``,
    ``return_onesided=False``, ``detrend=False``)."""
    import scipy.signal as sg

    if hasattr(signal, "signal"):
        sig = np.asarray(_host(signal.signal))
    elif _is_arraylike(signal):
        sig = np.asarray(_host(signal))
    else:
        raise TypeError("signal must be array_like or have a .signal attribute")

    nperseg = nperseg if nperseg is not None else min(2048, len(sig))
    f, psd = sg.welch(sig, fs=fs, nperseg=nperseg, scaling="spectrum",
                      return_onesided=False, detrend=False)
    return np.fft.fftshift(f), np.fft.fftshift(psd, axes=-1)


def phase_estimator(t, x, f: float):
    """Phase/amplitude of a known-frequency sinusoid via Huber-IRLS linear
    regression over ``[cos(wt), sin(wt)]`` (reference utils.py:1984-2045)."""
    x = np.asarray(_host(x)).ravel()
    t = np.asarray(_host(t)).ravel()
    if t.shape != x.shape:
        raise ValueError("t and x must have same shape")

    w = 2 * pi * f
    G = np.column_stack((np.cos(w * t), np.sin(w * t)))
    theta = np.linalg.lstsq(G, x, rcond=None)[0]
    huber_delta = 0.2
    for _ in range(50):
        r = x - G @ theta
        absr = np.abs(r)
        wght = np.where(absr > huber_delta,
                        huber_delta / np.maximum(absr, 1e-300), 1.0)
        Wr = np.sqrt(wght)
        theta_new = np.linalg.lstsq(G * Wr[:, None], x * Wr, rcond=None)[0]
        if np.linalg.norm(theta_new - theta) < 1e-20:
            theta = theta_new
            break
        theta = theta_new

    a, b = float(theta[0]), float(theta[1])
    return np.arctan2(-b, a), float(np.hypot(a, b))


def bode(H: np.ndarray, fs: float, f0: float = None, grid: bool = True,
         show: bool = True, ret: bool = False, style: str = "dark",
         xlabel: str = None):
    """Magnitude / phase / group-delay (/ dispersion) panels of a frequency
    response (reference utils.py:720-847).  Host-side Matplotlib."""
    import matplotlib.pyplot as plt

    H = np.asarray(_host(H))
    f = np.fft.fftshift(np.fft.fftfreq(H.size, d=1 / fs)) * 1e-9  # GHz
    npanels = 4 if f0 else 3
    fig, axs = plt.subplots(npanels, 1, sharex=True, figsize=(8, 2 * npanels))
    with np.errstate(divide="ignore"):
        axs[0].plot(f, 10 * np.log10(np.abs(H) ** 2))
    axs[0].set_ylabel("|H|² [dB]")
    axs[1].plot(f, phase(H))
    axs[1].set_ylabel("phase [rad]")
    axs[2].plot(f, tau_g(H, fs))
    axs[2].set_ylabel(r"$\tau_g$ [ps]")
    if f0:
        axs[3].plot(f, dispersion(H, fs, f0))
        axs[3].set_ylabel("D [ps/nm]")
    axs[-1].set_xlabel(xlabel or "f [GHz]")
    if grid:
        for ax in axs:
            ax.grid(alpha=0.3)
    if show:
        plt.show()
    if ret:
        return fig, axs


def apply_optimized_gaussian_filter(t: np.ndarray, signal: np.ndarray,
                                    T_bit: float) -> np.ndarray:
    """NRZ Gaussian smoothing with the BER-optimal width ``sigma =
    0.139 * T_bit`` (reference utils.py:1541-1590).

    The kernel spans ~6 sigma (odd length, >= 3 taps, capped at the signal
    length) and the output is renormalized so a full-swing NRZ transition
    keeps its amplitude.
    """
    t = np.asarray(_host(t), dtype=float)
    signal = np.asarray(_host(signal), dtype=float)
    dt = t[1] - t[0]
    if dt <= 0:
        raise ValueError("Time step dt must be positive.")

    sigma_pts = T_bit * 0.139 / dt
    ksize = int(6 * sigma_pts) | 1  # odd
    ksize = max(ksize, 3)
    ksize = min(ksize, max(3, (len(signal) - 2) | 1))

    k = np.arange(ksize) - ksize // 2
    kernel = np.exp(-0.5 * (k / sigma_pts) ** 2)
    kernel /= kernel.sum()
    out = np.convolve(signal, kernel, mode="same")
    peak = np.max(np.abs(out))
    if peak > 0:
        out = out * (np.max(np.abs(signal)) / peak)
    return out
