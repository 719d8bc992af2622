"""Split-step Fourier NLSE propagation (the reference scheme).

Port of ``opticomlib_tpu.ops.ssfm``: symmetric NL-L-NL steps with the
nonlinear operator frozen at the step start, and the step size adapted to a
maximum nonlinear phase rotation (Sinkin et al. 2003; reference
devices.py:1038-1206).  One step is

    B, H = nl_halfstep(A, gamma*h/2)          # Triton kernel
    A    = ifft(cmul(fft(B), E(h))) ; A = cmul(A, H)   # cuFFT + Triton

with ``E(h) = exp(-alpha*h/2) * exp(i*phi(w)*h)``.

Step control runs in float32 on the host, as the JAX loop runs it in
float32 on the device: ``z``, ``h`` and the next ``h`` are ``np.float32``
so the step count matches the JAX package's.  The adaptive loop reads
``max|A|^2`` back once per step (it decides ``h`` and termination).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels

__all__ = ["dispersion_phase", "alpha_per_km", "adaptive_h0",
           "ssfm_step_schedule", "max_power", "ssfm_while_inside",
           "ssfm_scan_inside"]

_LOG10E_X10 = 4.342944819032518  # 10*log10(e): dB/km -> 1/km divisor
_MAX_STEPS = 400_000  # runaway backstop, as in the JAX loop

f32 = np.float32


def dispersion_phase(w_rad_s: np.ndarray, beta2: float,
                     beta3: float) -> np.ndarray:
    """Real dispersion phase rate ``phi(w) = beta2/2*w^2 + beta3/6*w^3``
    [rad/km], w in rad/ps, natural FFT order (float32)."""
    w = np.asarray(w_rad_s, dtype=np.float64) * 1e-12  # rad/ps
    phi = beta2 / 2 * w**2 + beta3 / 6 * w**3
    return phi.astype(np.float32)


def alpha_per_km(alpha_db_km: float) -> float:
    """Attenuation coefficient 1/km from dB/km (reference devices.py:1137)."""
    return float(alpha_db_km) / _LOG10E_X10


def adaptive_h0(phi_max: float, gamma: float, maxP: float,
                length: float) -> float:
    """Initial adaptive step ``phi_max / (|gamma|·maxP)`` capped at the span
    length; a dark input (``maxP == 0``) gives the full span in one step."""
    denom = abs(gamma) * maxP
    if denom == 0:
        return float(length)
    return min(phi_max / denom, float(length))


def ssfm_step_schedule(length: float, h: float) -> np.ndarray:
    """Fixed step schedule: ``h``-sized steps plus a final remainder
    (reference ``min(h, length - z)`` clipping, devices.py:1196)."""
    n_full = int(math.floor(length / h + 1e-9))
    rem = length - n_full * h
    hs = [h] * n_full
    if rem > 1e-9 * max(length, 1.0):
        hs.append(rem)
    if not hs:
        hs = [length]
    return np.asarray(hs, dtype=np.float32)


def _lin_factor(phi_w: torch.Tensor, alpha: np.float32,
                h: np.float32) -> torch.Tensor:
    """Linear-step multiplier ``exp(-alpha/2*h) * exp(i*phi_w*h)``."""
    loss = np.exp(f32(-0.5) * alpha * h, dtype=np.float32)
    th = phi_w * float(h)
    return torch.polar(torch.full_like(th, float(loss)), th)


def _nl_l_nl_step(A: torch.Tensor, phi_w: torch.Tensor, alpha: np.float32,
                  h: np.float32, gamma: np.float32,
                  E: torch.Tensor = None) -> torch.Tensor:
    """One symmetric NL-L-NL split step (nonlinear operator frozen at the
    step start).  Pass a precomputed linear factor ``E`` when ``h`` is
    loop-constant."""
    B, H = kernels.nl_halfstep(A, gamma * (h / f32(2)))
    if E is None:
        E = _lin_factor(phi_w, alpha, h)
    A = torch.fft.ifft(kernels.cmul(torch.fft.fft(B, dim=-1), E), dim=-1)
    return kernels.cmul(A, H)


def max_power(A: torch.Tensor) -> np.float32:
    """``max|A|^2`` read back to the host (the per-step sync)."""
    return f32(torch.view_as_real(A).square().sum(-1).max().item())


def ssfm_while_inside(A: torch.Tensor, phi_w: torch.Tensor, length, gamma,
                      phi_max, h0, alpha, adaptive: bool):
    """phi_max-adaptive (``adaptive=True``) or fixed-``h0`` split-step
    propagation over ``length`` km of ``A`` (complex64, last axis = time).
    Returns ``(A, n_steps)``."""
    alpha, length, gamma = f32(alpha), f32(length), f32(gamma)
    phi_max, h0 = f32(phi_max), f32(h0)
    # minimum step: float32 z-accumulation stalls when h < ulp(z)
    h_floor = length * f32(1.5e-7)
    z, h, steps = f32(0.0), min(h0, length), 0
    with np.errstate(divide="ignore"):
        while z < length and steps < _MAX_STEPS:
            z = z + h
            A = _nl_l_nl_step(A, phi_w, alpha, h, gamma)
            if adaptive:
                h_next = phi_max / (abs(gamma) * max_power(A))
            else:
                h_next = h0
            h = max(min(h_next, length - z), h_floor)
            steps += 1
    return A, steps


def ssfm_scan_inside(A: torch.Tensor, phi_w: torch.Tensor, hs, gamma,
                     alpha) -> torch.Tensor:
    """Fixed-schedule propagation over the float32 step sizes ``hs``.  The
    linear factor of the leading step size is built once; an off-schedule
    step (the final remainder) builds its own."""
    alpha, gamma = f32(alpha), f32(gamma)
    hs = np.asarray(hs, dtype=np.float32)
    E0 = _lin_factor(phi_w, alpha, hs[0])
    for h in hs:
        E = E0 if h == hs[0] else None
        A = _nl_l_nl_step(A, phi_w, alpha, h, gamma, E=E)
    return A
