"""Zero-phase Bessel filtering as an FFT-domain multiply.

``filtfilt`` is zero-phase by construction: its transfer function is
``|H(w)|^2`` of the designed filter, so the filter is applied as
``ifft(fft(x) * |H|^2)`` (circular boundaries, like the JAX package).  The
response is designed on the host with scipy (copied from
``opticomlib_tpu.ops.filters``; reference devices.py:1286-1375).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as sg
import torch

__all__ = ["bessel_sos_response", "bessel_filtfilt_response",
           "apply_freq_response", "bessel_lpf"]


@lru_cache(maxsize=256)
def bessel_sos_response(n: int, BW: float, fs: float,
                        nfft: int) -> np.ndarray:
    """One-pass frequency response H(w) of the reference's Bessel design
    (``sg.bessel(N=n, Wn=BW, btype='low', fs=fs, norm='mag')``) sampled at
    the ``nfft`` FFT bin frequencies (natural FFT order).  complex128."""
    if BW < 0.5 * fs:
        sos = sg.bessel(N=n, Wn=BW, btype="low", fs=fs, output="sos",
                        norm="mag")
        _, H = sg.sosfreqz(sos, worN=nfft, fs=fs, whole=True)
        return H
    # Cutoff at/above Nyquist: the bilinear design is undefined (the
    # reference's sosfiltfilt would raise here).  Sample the *analog*
    # Bessel prototype response instead — same magnitude semantics,
    # valid for any BW.
    b, a = sg.bessel(N=n, Wn=2 * np.pi * BW, btype="low", analog=True,
                     output="ba", norm="mag")
    w = 2 * np.pi * fs * np.fft.fftfreq(nfft)
    _, H = sg.freqs(b, a, worN=w)
    return H


@lru_cache(maxsize=256)
def bessel_filtfilt_response(n: int, BW: float, fs: float,
                             nfft: int) -> np.ndarray:
    """Zero-phase (filtfilt-equivalent) response ``|H(w)|^2`` as float32."""
    H = bessel_sos_response(n, BW, fs, nfft)
    return (np.abs(H) ** 2).astype(np.float32)


def apply_freq_response(x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Multiply the spectrum of ``x`` (last axis) by ``H`` (natural FFT
    order) and return to the time domain.  Real input -> real output."""
    y = torch.fft.ifft(torch.fft.fft(x, dim=-1) * H, dim=-1)
    return y if x.is_complex() else y.real


@lru_cache(maxsize=4)
def _device_response(n: int, BW: float, fs: float, nfft: int,
                     device: torch.device) -> torch.Tensor:
    """:func:`bessel_filtfilt_response` as float64 on ``device``, copied
    once for each design and length."""
    H2 = bessel_filtfilt_response(n, BW, fs, nfft).astype(np.float64)
    return torch.as_tensor(H2, device=device)


def bessel_lpf(x: torch.Tensor, BW: float, fs: float,
               n: int = 4) -> torch.Tensor:
    """Zero-phase Bessel low-pass of the last axis of ``x`` (the operator of
    the reference's ``sg.sosfiltfilt(sg.bessel(n, BW, norm='mag'), x)``,
    devices.py:1363-1368, up to boundary handling).  The response is
    applied in float64, as the JAX package's NumPy path applies it; it is
    kept on ``x``'s device for the next call of the same design and
    length."""
    return apply_freq_response(x, _device_response(
        n, float(BW), float(fs), int(x.shape[-1]), x.device))
