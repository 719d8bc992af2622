"""Simulation parameters: :class:`SimParams`, copied from
``opticomlib_tpu.params`` (NumPy only).  The mutable ``gv`` facade is not
ported: the port takes explicit parameters everywhere."""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
from scipy.constants import c as _c

logger = logging.getLogger("opticomlib_tpu_torch")

_DEFAULT_SPS = 16
_DEFAULT_R = 1e9
_DEFAULT_N = 128
_DEFAULT_WAVELENGTH = 1550e-9

__all__ = ["SimParams"]


@dataclass(frozen=True)
class SimParams:
    """Immutable simulation parameters.

    Attributes
    ----------
    sps : int
        Samples per slot.
    R : float
        Slot rate [Hz].
    fs : float
        Sampling frequency [Samples/s] (``R * sps``).
    N : int
        Number of slots simulated.
    wavelength : float
        Optical carrier wavelength [m].
    """

    sps: int = _DEFAULT_SPS
    R: float = _DEFAULT_R
    fs: float = float(_DEFAULT_R * _DEFAULT_SPS)
    N: int = _DEFAULT_N
    wavelength: float = _DEFAULT_WAVELENGTH

    # ---- derived quantities (host-side, cheap) ----
    @property
    def dt(self) -> float:
        """Time step [s]."""
        return 1.0 / self.fs

    @property
    def f0(self) -> float:
        """Optical carrier frequency [Hz]."""
        return _c / self.wavelength

    @property
    def nsamples(self) -> int:
        """Total number of samples in the simulation window (``N * sps``)."""
        return self.N * self.sps

    @property
    def dw(self) -> float:
        """Angular-frequency resolution [rad/s]."""
        return 2 * np.pi * self.fs / self.nsamples

    @property
    def t(self) -> np.ndarray:
        """Time axis [s].  Matches reference typing.py:356 (endpoint=True)."""
        n = self.nsamples
        return np.linspace(0.0, n / self.fs, n, endpoint=True)

    @property
    def w(self) -> np.ndarray:
        """Angular-frequency axis [rad/s] in *fftshift-of-fftfreq* order.

        This mirrors the reference layout (typing.py:359):
        ``2*pi*fftshift(fftfreq(n))*fs`` - i.e. an axis that is *monotonic*
        after being paired with an un-shifted FFT; devices that build
        frequency responses index it accordingly.
        """
        n = self.nsamples
        return 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(n)) * self.fs

    @property
    def w_fftorder(self) -> np.ndarray:
        """Angular-frequency axis [rad/s] in natural FFT (unshifted) order."""
        n = self.nsamples
        return 2 * np.pi * np.fft.fftfreq(n) * self.fs

    # ---- constructors ----
    @classmethod
    def create(
        cls,
        sps: Optional[int] = None,
        R: Optional[float] = None,
        fs: Optional[float] = None,
        N: Optional[int] = None,
        wavelength: float = _DEFAULT_WAVELENGTH,
        _warn: bool = True,
        base: Optional["SimParams"] = None,
    ) -> "SimParams":
        """Build params applying the reference's reconciliation rules
        (typing.py:306-333) for partially-specified (sps, R, fs).

        ``base``: fallback values for omitted members of the triple.  The
        reference falls back to the *currently configured* ``self.R`` /
        ``self.sps`` (its warning text says "default" but the value it
        keeps is the current one) — ``gv`` passes its live params here so
        incremental calls like ``gv(N=...)`` don't reset the rates."""

        def _w(msg, *args):
            if _warn:
                logger.warning(msg, *args)

        fb_R = base.R if base is not None else _DEFAULT_R
        fb_sps = base.sps if base is not None else _DEFAULT_SPS
        if sps:
            sps = int(np.round(sps))
            if R:
                fs = R * sps
            elif fs:
                R = fs / sps
            else:
                R = fb_R
                _w("'R' kept at its current value (%.2e bits/s)", R)
                fs = R * sps
        elif R:
            if fs:
                sps = int(np.round(fs / R))
            else:
                sps = fb_sps
                _w("'sps' kept at its current value (%d S/bit)", sps)
                fs = R * sps
        elif fs:
            R = fb_R
            _w("'R' kept at its current value (%.2e bits/s)", R)
            sps = int(np.round(fs / R))
        else:
            sps, R = fb_sps, fb_R
            fs = base.fs if base is not None else R * sps
            _w(
                "'sps', 'R' and 'fs' keep their current values "
                "(%d S/bit, %.2e bits/s, %.2e Hz)",
                sps, R, fs,
            )

        return cls(
            sps=int(sps),
            R=float(R),
            fs=float(fs),
            N=int(N) if N is not None else _DEFAULT_N,
            wavelength=float(wavelength),
        )

    def replace(self, **kwargs: Any) -> "SimParams":
        return dataclasses.replace(self, **kwargs)

    def __str__(self) -> str:
        np.set_printoptions(precision=2, threshold=20)
        title = "***    Simulation Parameters    ***"
        sub = len(title) * "-"
        return (
            f"\n{sub}\n{title}\n{sub}\n"
            f"\tsps :  {self.sps}\n"
            f"\tR   :  {self.R:.2e}\n"
            f"\tfs  :  {self.fs:.2e}\n"
            f"\tλ0  :  {self.wavelength:.2e}\n"
            f"\tf0  :  {self.f0:.2e}\n"
            f"\tN   :  {self.N}\n"
            f"\tdt  :  {self.dt:.2e}\n"
            f"\tt   :  {self.t}\n"
            f"\tdw  :  {self.dw:.2e}\n"
        )
