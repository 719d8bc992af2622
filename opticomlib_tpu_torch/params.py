"""Simulation parameters: the immutable :class:`SimParams` and the mutable
``gv`` facade of the staged devices (copied from ``opticomlib_tpu.params``,
NumPy only).  The fused link takes explicit parameters; the staged devices
read ``gv``, and the sources among them (``DAC``, ``LASER``, and signals
built from host data) put their tensors on ``gv``'s device.  The default is
the card (``"cuda"``): a caller who names no device runs on it, and without
a card the first source raises; there is no quiet run on the CPU.
``gv(device="cpu")`` asks for the CPU, and has to be said again after
``gv.default()``, which clears it."""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from scipy.constants import c as _c

logger = logging.getLogger("opticomlib_tpu_torch")

_DEFAULT_SPS = 16
_DEFAULT_R = 1e9
_DEFAULT_N = 128
_DEFAULT_WAVELENGTH = 1550e-9

__all__ = ["SimParams", "GlobalVariables", "global_variables", "gv",
           "resolve_params", "current_device", "check_device"]


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


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is available (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available "
            "(torch.cuda.is_available() is False); use device='cpu'")
    return device


class GlobalVariables:
    """Mutable facade with the reference ``gv`` interface
    (reference: opticomlib/typing.py:106-388) backed by an immutable
    :class:`SimParams`.

    Custom user variables set via ``gv(foo=...)`` are stored in
    ``self._extras`` and exposed as attributes; ``default()`` resets
    everything and deletes the extras, matching typing.py:361-386.  Two
    extras act: ``seed`` seeds the keyed-noise stream
    (:mod:`opticomlib_tpu_torch.rng`) and ``device`` is where the sources
    put their tensors (checked when set; the card when not set).
    """

    _CORE = ("sps", "R", "fs", "dt", "wavelength", "f0", "N", "t", "w", "dw",
             "nsamples", "params", "plt_style", "verbose")

    def __init__(self) -> None:
        object.__setattr__(self, "params", SimParams())
        object.__setattr__(self, "plt_style", "fast")
        object.__setattr__(self, "verbose", None)
        object.__setattr__(self, "_extras", {})

    # -- delegation to SimParams --
    def __getattr__(self, name: str):
        # only called when normal lookup fails
        params = object.__getattribute__(self, "params")
        if name in ("sps", "R", "fs", "N", "wavelength", "dt", "f0", "t",
                    "w", "dw", "nsamples", "w_fftorder"):
            return getattr(params, name)
        extras = object.__getattribute__(self, "_extras")
        if name in extras:
            return extras[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("params", "plt_style", "verbose", "_extras"):
            object.__setattr__(self, name, value)
        elif name in ("sps", "R", "fs", "N", "wavelength"):
            object.__setattr__(self, "params",
                               self.params.replace(**{name: value}))
        else:
            if name == "device":
                check_device(value)
            self._extras[name] = value

    def __call__(
        self,
        sps: Optional[int] = None,
        R: Optional[float] = None,
        fs: Optional[float] = None,
        wavelength: float = _DEFAULT_WAVELENGTH,
        N: Optional[int] = None,
        plt_style: str = "fast",
        verbose=None,
        **kwargs: Any,
    ) -> "GlobalVariables":
        if verbose is not None:
            self.verbose = verbose
            logger.setLevel(verbose)

        new = SimParams.create(sps=sps, R=R, fs=fs, N=None,
                               wavelength=wavelength, base=self.params)
        n_slots = int(N) if N is not None else self.params.N
        object.__setattr__(self, "params", new.replace(N=n_slots))
        if plt_style != self.plt_style:
            self.plt_style = plt_style
            try:  # matplotlib is optional in the compute path
                import matplotlib.pyplot as plt

                plt.rcdefaults()
                plt.style.use(plt_style)
            except Exception:
                pass

        if "device" in kwargs:
            check_device(kwargs["device"])
        for key, value in kwargs.items():
            self._extras[key] = value
            if key == "seed":  # seed the keyed-noise stream
                from . import rng
                rng.seed(int(value))
        return self

    def default(self) -> "GlobalVariables":
        object.__setattr__(self, "params", SimParams())
        self.plt_style = "fast"
        self.verbose = None
        logger.setLevel(logging.NOTSET)
        if "seed" in self._extras:
            from . import rng
            rng.clear()
        self._extras.clear()
        return self

    def print(self) -> "GlobalVariables":
        print(self)
        return self

    def __str__(self) -> str:
        msg = str(self.params)
        msg += (
            "  Config\n  ------\n"
            f"\tplt_style :  \"{self.plt_style}\"\n"
            f"\tverbose   :  {self.verbose}\n"
        )
        if self._extras:
            msg += "  Custom\n  ------\n\t" + "\n\t".join(
                f"{k} : {v}" for k, v in self._extras.items()) + "\n"
        return msg


# Reference-compatible aliases (opticomlib exposes `global_variables` + `gv`).
global_variables = GlobalVariables
gv = GlobalVariables()


def resolve_params(params: Optional[SimParams]) -> SimParams:
    """Return ``params`` if given, else the current global configuration."""
    return params if params is not None else gv.params


def current_device() -> torch.device:
    """The device of ``gv``: ``gv(device=...)``, else the card.  Raises when
    that is a CUDA device and no card is available."""
    if "device" in gv._extras:
        return check_device(gv._extras["device"])
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gv names no device, so the staged devices run on the card "
            "('cuda'), and no CUDA device is available "
            "(torch.cuda.is_available() is False); ask for the CPU with "
            "gv(device='cpu')")
    return torch.device("cuda")
