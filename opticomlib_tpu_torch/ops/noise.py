"""Noise draws and the amplifier-noise physics.

``ase_power``/``ase_sigma`` are copied from ``opticomlib_tpu.ops.noise``
(reference devices.py:930-936).  Draws come from an explicit
``torch.Generator`` on the target device: torch's Philox stream cannot
reproduce JAX's threefry keys, so tests that compare the two packages inject
the JAX draws instead (see ``LinkProgram.forward(noise=...)``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ase_power", "ase_sigma", "gaussian"]


def gaussian(shape, sigma, generator: torch.Generator,
             draw: torch.Tensor = None) -> torch.Tensor:
    """``sigma * N(0,1)`` float32 draws on the generator's device.

    ``sigma``: a float or a 0-d tensor on that device.  ``draw``: unit
    normals of ``shape`` to use instead of the generator's (noise
    injection)."""
    if draw is None:
        draw = torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
    elif tuple(draw.shape) != tuple(shape):
        raise ValueError(f"injected draw has shape {tuple(draw.shape)}, "
                         f"expected {tuple(shape)}")
    if not isinstance(sigma, torch.Tensor):
        sigma = float(np.float32(sigma))
    return draw * sigma


def ase_power(G_dB: float, NF_dB: float, f0: float, fs: float) -> float:
    """Total EDFA ASE noise power ``idb(NF)·h·f0·(G−1)·fs`` [W]."""
    from scipy.constants import h as h_planck
    G_lin = 10.0 ** (G_dB / 10.0)
    if G_lin < 1.0:
        # the reference's formula would yield negative power (NaN sigma);
        # fail loudly instead.  G = 0 dB is allowed and gives P_ase = 0.
        raise ValueError("ASE requires gain >= 0 dB (got negative power)")
    return 10.0 ** (NF_dB / 10.0) * h_planck * f0 * (G_lin - 1.0) * fs


def ase_sigma(G_dB: float, NF_dB: float, f0: float, fs: float) -> float:
    """Per-quadrature ASE standard deviation: ``P_ase`` split over 2
    polarizations × (re, im) quadratures → ``sqrt(P_ase/4)``."""
    return float(np.sqrt(ase_power(G_dB, NF_dB, f0, fs) / 4.0))
