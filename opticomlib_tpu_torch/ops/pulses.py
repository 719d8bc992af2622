"""Pulse taps and FFT resampling.

The pulse taps are host-side NumPy constants (copied from
``opticomlib_tpu.ops.pulses``, reference utils.py:1791-1946); zero-stuff
upsampling and FFT resampling run on torch tensors, on the tensor's own
device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["nrz_pulse", "gauss_pulse", "rcos_pulse", "upsample_zero_stuff",
           "resample_fft"]


# ---------------------------------------------------------------------------
# pulse shapes (host-side constants; reference utils.py:1791-1946)
# ---------------------------------------------------------------------------
def nrz_pulse(span: int, sps: int, T: float = 1) -> np.ndarray:
    """Rectangular pulse of width ``T`` slots over ``span`` slots."""
    N = span * sps
    t = np.linspace(-span / 2, span / 2, N + 1)
    return np.where((t >= -T / 2) & (t < T / 2), 1.0, 0.0)


def gauss_pulse(span: int, sps: int, T: float = 1, m: int = 1,
                c: float = 0.0) -> np.ndarray:
    """(Super-)Gaussian pulse of FWHM ``T`` slots, order ``m``, chirp ``c``.

    NOTE reference parity quirk (utils.py:1918-1921): the chirp factor
    ``(1+1j*c)`` sits *inside* the ``**(2*m)`` power, so the magnitude
    depends on ``c`` and diverges for ``|c| >= 1`` (the textbook chirped
    Gaussian is ``exp(-(1+ic)(at)^(2m))`` with chirp-independent
    magnitude).  Kept bit-for-bit for drop-in equivalence; pass a custom
    ``h`` to DAC for the textbook form."""
    N = span * sps
    t = np.linspace(-span / 2, span / 2, N + 1)
    alpha = 2 * np.sqrt(np.log(2)) / T
    return np.exp(-((alpha * (1 + 1j * c) * t) ** (2 * m)))


def rcos_pulse(beta: float, span: int, sps: int,
               shape: str = "sqrt") -> np.ndarray:
    """Raised-cosine / root-raised-cosine impulse response (MATLAB
    ``rcosdesign`` semantics; behavioral spec: reference utils.py:1791-1878).

    Evaluated through singularity-free sinc identities instead of the
    textbook rational forms, so no limit special-casing is needed anywhere
    (``np.sinc`` handles its own removable zero):

    * **RC.**  ``cos(pi b t) / (1 - (2 b t)^2)`` decomposes by partial
      fractions into ``(pi/4) * [sinc(b t + 1/2) + sinc(b t - 1/2)]``,
      giving ``h(t) = sinc(t) * (pi/4) * [sinc(bt+1/2) + sinc(bt-1/2)]``.
    * **RRC.**  Integrating the square-root spectrum
      (flat to ``(1-b)/2``, cosine roll-off to ``(1+b)/2``) band by band
      and folding the roll-off integrals with product-to-sum identities
      yields ``h(t) = (1-b) sinc((1-b) t)
      + b [sinc(bt - 1/4) cos(pi t - pi/4) - sinc(bt + 1/4) sin(pi t - pi/4)]``.

    Both collapse to ``sinc(t)`` at ``beta = 0`` with no branch, and agree
    with the rational forms (and their L'Hopital limits at ``t = 0``,
    ``1/(2 beta)``, ``1/(4 beta)``) to float64 round-off.
    """
    if not (0 <= beta <= 1):
        raise ValueError("beta must be in [0, 1]")
    shape = shape.lower()
    if shape not in ("sqrt", "normal"):
        raise ValueError("shape must be 'sqrt' or 'normal'")

    t = np.linspace(-span / 2, span / 2, span * sps + 1)
    if beta == 0:
        return np.sinc(t)

    if shape == "normal":
        return (np.sinc(t) * (np.pi / 4)
                * (np.sinc(beta * t + 0.5) + np.sinc(beta * t - 0.5)))

    a = np.pi * t - np.pi / 4
    return ((1 - beta) * np.sinc((1 - beta) * t)
            + beta * (np.sinc(beta * t - 0.25) * np.cos(a)
                      - np.sinc(beta * t + 0.25) * np.sin(a)))


# ---------------------------------------------------------------------------
# upsampling / resampling (torch, on the input's device)
# ---------------------------------------------------------------------------
def upsample_zero_stuff(x: torch.Tensor, up: int) -> torch.Tensor:
    """Insert ``up-1`` zeros between samples, with the reference's phase
    offset of ``up//2`` (reference utils.py:1975-1977).  Integer input
    becomes float32."""
    dtype = x.dtype if (x.is_floating_point() or x.is_complex()) \
        else torch.float32
    n = x.shape[-1]
    xu = torch.zeros(x.shape[:-1] + (n, up), dtype=dtype, device=x.device)
    xu[..., :, up // 2] = x
    return xu.reshape(x.shape[:-1] + (n * up,))


def resample_fft(x: torch.Tensor, num: int) -> torch.Tensor:
    """FFT-domain resampling of the last axis with ``scipy.signal.resample``
    semantics (Nyquist-bin splitting on even lengths).  Real input -> real
    output."""
    n = x.shape[-1]
    if num == n:
        return x
    was_real = not x.is_complex()
    X = torch.fft.fft(x, dim=-1)
    N = min(num, n)
    nyq = N // 2 + 1
    Y = torch.zeros(x.shape[:-1] + (num,), dtype=X.dtype, device=x.device)
    Y[..., :nyq] = X[..., :nyq]
    if N > 2:
        Y[..., num - (N - nyq):] = X[..., n - (N - nyq):]
    if N % 2 == 0:
        if num < n:
            Y[..., N // 2] += X[..., n - N // 2]
        else:
            Y[..., N // 2] *= 0.5
            Y[..., num - N // 2] = Y[..., N // 2]
    y = torch.fft.ifft(Y, dim=-1) * (num / n)
    return y.real if was_real else y
