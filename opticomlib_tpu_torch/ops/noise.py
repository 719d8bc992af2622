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

__all__ = ["ase_power", "ase_sigma", "gaussian", "as_draw", "wiener_phase",
           "running_sum", "ase_draws", "keyed_generator"]


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


def as_draw(d, device) -> torch.Tensor:
    """Injected unit draws ``d`` (an array, a list or a tensor) as a
    float32 tensor on ``device``: the ``draw`` that :func:`gaussian`
    takes."""
    if not isinstance(d, torch.Tensor):
        d = torch.from_numpy(np.array(d, dtype=np.float32))
    return d.to(device=device, dtype=torch.float32)


def keyed_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded by the non-negative integers ``key``
    (mixed by NumPy's ``SeedSequence``): draws that are a function of a
    logical position, e.g. (channel seed, noise stage, block), whatever
    computes them when."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(k) for k in key])
                        .generate_state(1, np.uint64)[0]))
    return gen


def wiener_phase(n: int, sigma_step, generator: torch.Generator,
                 draw: torch.Tensor = None) -> torch.Tensor:
    """Wiener (random-walk) laser phase: the float32 cumulative sum of
    ``n`` draws of ``N(0, sigma_step^2)`` (port of
    ``opticomlib_tpu.ops.noise.wiener_phase_inside``; reference
    devices.py:485-490).  ``draw``: unit normals to use instead of the
    generator's.  torch and XLA sum in different orders, so the walk agrees
    with the JAX one to float32 round-off, not bit for bit; one seed gives
    one walk (:func:`running_sum`)."""
    return running_sum(gaussian((n,), sigma_step, generator, draw))


_SCAN_BLOCK = 1024


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis, the same bits on every call.

    torch's CUDA ``cumsum`` of a single run longer than one tile is a
    decoupled look-back scan: how it adds the tiles' sums depends on which
    tile finishes first, so two calls on the same float32 input differ in
    round-off.  Here each block of 1024 samples is scanned alone (a scan
    along the last axis of a 2-D view, in a fixed order) and the blocks'
    totals the same way, recursively; a run of at most one block is one
    tile."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return torch.cumsum(x, dim=-1)
    R = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, R * _SCAN_BLOCK - n)).reshape(
        x.shape[:-1] + (R, _SCAN_BLOCK))
    inner = torch.cumsum(blocks, dim=-1)
    before = torch.nn.functional.pad(running_sum(inner[..., -1])[..., :-1],
                                     (1, 0))
    return (inner + before[..., None]).reshape(
        x.shape[:-1] + (R * _SCAN_BLOCK,))[..., :n]


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


def ase_draws(n: int, P_ase: float, generator: torch.Generator,
              draw: torch.Tensor = None) -> torch.Tensor:
    """EDFA ASE field noise on the generator's device: a (2, n) complex128
    tensor, 2 polarizations x (re, im) quadratures of ``N(0, P_ase/4)``
    each, drawn in float32 (port of ``opticomlib_tpu.ops.noise.ase_draws``;
    reference devices.py:930-936).  ``draw``: ``(4, n)`` unit normals to
    use instead of the generator's."""
    d = gaussian((4, n), np.sqrt(P_ase / 4), generator,
                 draw).to(torch.float64)
    return torch.complex(d[:2], d[2:])
