"""Pulse taps, FIR shaping and FFT resampling.

The pulse taps are host-side NumPy constants (copied from
``opticomlib_tpu.ops.pulses``, reference utils.py:1791-1946); zero-stuff
upsampling, the ``mode='same'`` convolution of the DAC (:func:`upfir`,
:func:`fft_convolve_same`) and FFT resampling run on torch tensors, on the
tensor's own device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels

__all__ = ["nrz_pulse", "gauss_pulse", "rcos_pulse", "upsample_zero_stuff",
           "resample_fft", "fir_taps", "fft_convolve_same", "upfir"]


# ---------------------------------------------------------------------------
# pulse shapes (host-side constants; reference utils.py:1791-1946)
# ---------------------------------------------------------------------------
def _grid(span: int, sps: int, window: Optional[Tuple[int, int]]):
    """``np.linspace(-span/2, span/2, span*sps + 1)``, or its points
    ``[i0, i1)`` for ``window=(i0, i1)``: the same floats, computed as
    linspace computes them (``i*step + start``, the last point ``stop``)."""
    num = span * sps + 1
    if window is None:
        return np.linspace(-span / 2, span / 2, num)
    i0, i1 = max(int(window[0]), 0), min(int(window[1]), num)
    t = np.arange(i0, i1, dtype=np.float64) * (span / (num - 1)) - span / 2
    if i1 == num and i1 > i0:
        t[-1] = span / 2
    return t


def nrz_pulse(span: int, sps: int, T: float = 1,
              window: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Rectangular pulse of width ``T`` slots over ``span`` slots
    (``window``: only the grid points ``[i0, i1)``)."""
    t = _grid(span, sps, window)
    return np.where((t >= -T / 2) & (t < T / 2), 1.0, 0.0)


def gauss_pulse(span: int, sps: int, T: float = 1, m: int = 1,
                c: float = 0.0,
                window: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(Super-)Gaussian pulse of FWHM ``T`` slots, order ``m``, chirp ``c``
    (``window``: only the grid points ``[i0, i1)``, the same values).

    NOTE reference parity quirk (utils.py:1918-1921): the chirp factor
    ``(1+1j*c)`` sits *inside* the ``**(2*m)`` power, so the magnitude
    depends on ``c`` and diverges for ``|c| >= 1`` (the textbook chirped
    Gaussian is ``exp(-(1+ic)(at)^(2m))`` with chirp-independent
    magnitude).  Kept bit-for-bit for drop-in equivalence; pass a custom
    ``h`` to DAC for the textbook form."""
    t = _grid(span, sps, window)
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
# FIR shaping, mode='same' (torch, on the input's device)
# ---------------------------------------------------------------------------
def _trim(h: np.ndarray):
    """``(h[a:b], a)`` without the exactly-zero taps at both ends."""
    nz = np.flatnonzero(h)
    if nz.size == 0:
        return h[:0], 0
    return h[nz[0]:nz[-1] + 1], int(nz[0])


def fir_taps(h, m: Optional[int] = None, start: int = 0):
    """The kernel route's taps for the ``m``-tap kernel whose taps
    ``[start, start + len(h))`` are ``h`` (the rest zero; ``m`` defaults to
    ``len(h)``): ``(taps, s)`` with ``taps`` the float32 taps without their
    exactly-zero ends and ``s = (m-1)//2 - a`` the advance of the input
    (``a`` the index of the first kept tap), or ``None`` when the rule
    sends the convolution to the FFT route: complex taps, or more than
    ``kernels.FIR_MAX_TAPS`` taps left after the trim."""
    h = np.asarray(h)
    m = h.shape[-1] if m is None else int(m)
    if np.iscomplexobj(h):
        return None
    taps, a = _trim(h.astype(np.float32))
    if taps.size > kernels.FIR_MAX_TAPS:
        return None
    return taps, (m - 1) // 2 - (start + a)


def _fir_same(x: torch.Tensor, taps: np.ndarray, s: int) -> torch.Tensor:
    """``y[k] = sum_i taps[i] x[k + s - i]`` over the last axis, by the
    ``fir_filter`` kernel (float32): for ``s > 0`` the input gets ``s``
    zeros at its tail and the first ``s`` outputs are dropped; for
    ``s < 0`` it is delayed by ``-s`` samples."""
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    if taps.size == 0:
        return torch.zeros_like(rows, dtype=torch.float32).reshape(x.shape)
    h = torch.as_tensor(taps, device=x.device)
    if s >= 0:
        rows = torch.nn.functional.pad(rows, (0, s))
    else:
        rows = torch.nn.functional.pad(rows, (-s, 0))[:, :n]
    out = torch.stack([kernels.fir_filter(r.contiguous(), h) for r in rows])
    return out[:, max(s, 0):].reshape(x.shape)


def _fft_same(x: torch.Tensor, h: np.ndarray, m: int,
              start: int) -> torch.Tensor:
    """``mode='same'`` linear convolution by FFT (the JAX function, with the
    taps' exactly-zero ends trimmed): ``y[k] = full[k + (m-1)//2]`` of the
    full convolution with the ``m``-tap kernel, in ``x``'s dtype."""
    h, a = _trim(h)
    n = x.shape[-1]
    if h.size == 0:
        return torch.zeros_like(x)
    hh = torch.as_tensor(h, device=x.device).to(x.dtype)
    nfft = _next_fast_len(n + h.size - 1)
    if x.is_complex():
        full = torch.fft.ifft(torch.fft.fft(x, nfft, dim=-1)
                              * torch.fft.fft(hh, nfft), dim=-1)
    else:
        full = torch.fft.irfft(torch.fft.rfft(x, nfft, dim=-1)
                               * torch.fft.rfft(hh, nfft), nfft, dim=-1)
    # output k is full[k + s]; zero outside the full convolution
    s = (m - 1) // 2 - (start + a)
    lo, hi = max(s, 0), min(s + n, n + h.size - 1)
    y = torch.zeros_like(x)
    if hi > lo:
        y[..., lo - s:hi - s] = full[..., lo:hi]
    return y


def fft_convolve_same(x: torch.Tensor, h, m: Optional[int] = None,
                      start: int = 0) -> torch.Tensor:
    """Linear convolution of ``x`` (last axis) with the 1-D kernel ``h``,
    returning the central ``len(x)`` samples (scipy ``mode='same'``; port of
    ``opticomlib_tpu.ops.pulses.fft_convolve_same``).  ``m``/``start``: ``h``
    holds taps ``[start, start + len(h))`` of an ``m``-tap kernel whose
    other taps are zero (a pulse evaluated only where it is nonzero).

    Two routes, chosen by a size and dtype rule before anything launches
    (:func:`fir_taps`), not by a fallback on failure:

    * **kernel route** — real taps that, cast to float32 and without their
      exactly-zero ends, number at most ``kernels.FIR_MAX_TAPS``: the causal
      ``fir_filter`` kernel on the input advanced by ``(m-1)//2 - a``
      samples (``a`` the first kept tap), computed in float32 (a zero tap
      adds exactly zero there, so the trim changes nothing) and returned in
      the dtype the FFT route would give.  A complex ``x`` is filtered as
      its real and imaginary parts.
    * **FFT route** — complex taps (a chirped gaussian), or longer taps (the
      raised cosine's sinc tails, long custom ``h``): the JAX function's
      ``rfft``/``fft`` product in the promoted dtype (float64 for the DAC).
    """
    h = np.asarray(h)
    m = h.shape[-1] if m is None else int(m)
    # the dtype of the result, as the JAX function's NumPy path gives it
    dtype = torch.promote_types(x.dtype, torch.from_numpy(h[:0]).dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.float64
    fir = fir_taps(h, m, start)
    if fir is None:
        return _fft_same(x.to(dtype), h, m, start)
    taps, s = fir
    if x.is_complex():
        y = torch.complex(_fir_same(x.real.to(torch.float32), taps, s),
                          _fir_same(x.imag.to(torch.float32), taps, s))
    else:
        y = _fir_same(x.to(torch.float32), taps, s)
    return y.to(dtype)


def upfir(x: torch.Tensor, h, up: int = 1, m: Optional[int] = None,
          start: int = 0) -> torch.Tensor:
    """Zero-stuff upsample by ``up`` then FIR filter (``mode='same'``;
    MATLAB ``upfirdn``-style, reference utils.py:1949-1981).  ``m``/``start``
    as in :func:`fft_convolve_same`."""
    xu = upsample_zero_stuff(x, up) if up > 1 else x
    return fft_convolve_same(xu, h, m, start)


def _next_fast_len(n: int) -> int:
    """Next 5-smooth length >= n (FFT-friendly; copied from the JAX
    package)."""
    if n <= 2:
        return n
    best = 1 << (n - 1).bit_length()  # fallback: next pow2
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            v = p35
            while v < n:
                v *= 2
            if v < best:
                best = v
            p35 *= 3
        p5 *= 5
    return best


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
