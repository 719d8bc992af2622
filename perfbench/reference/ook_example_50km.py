"""Plain reference of ``ook_example_50km``, the upstream OOK example through
the staged devices: :func:`perfbench.reference.plainlink.run`'s link and
receiver, with the two departures that the staged chain makes from the
fused link, written here:

* the DAC: the staged ``DAC`` convolves the upsampled bits with the pulse
  linearly (``mode='same'``: zero before the first bit and after the
  last), where :func:`plainlink.transmit` convolves circularly.  Here the
  bits get at least ``pulse_span`` zero bits after them (to a count with
  no prime factor above 5, a quick transform's length), so that the
  circular convolution wraps nothing but zeros onto the first and last
  bits, and the first ``n`` samples are kept;
* the threshold: ``ook.THRESHOLD_EST`` scans ``0.5 [Q((mu1 - r)/s1) +
  Q((r - mu0)/s0)]`` in linear space over 1000 points between the levels
  and takes the first minimum, where :func:`plainlink.decide` scans the
  same sum in log space.  The two agree while the tails stay above
  float64's smallest number (this link's eye opens to some 11 ``s`` each
  side, Q about 1e-29); where both underflow to 0 over the middle of the
  scan, the linear scan takes the first point where they do.  Here the
  scan is the same sum in float64 NumPy and SciPy.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erfc

from perfbench.reference import plainlink


def _smooth(m: int) -> int:
    """The least whole number at or above ``m`` with no prime factor above
    5."""
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def transmit(cfg: dict, bits: torch.Tensor, draws: dict, p, dev):
    """DAC -> laser -> MZM with the DAC's linear convolution: the launch
    field ``(n,)``."""
    link = cfg["link"]
    if link["lw"] or link["rin"] is not None:
        raise NotImplementedError("laser noise: the padded bits would "
                                  "need padded draws")
    pad = torch.zeros(_smooth(bits.numel() + int(link["pulse_span"]))
                      - bits.numel(), dtype=bits.dtype, device=bits.device)
    return plainlink.transmit(cfg, torch.cat([bits, pad]), draws, p,
                              dev)[:bits.numel() * cfg["params"]["sps"]]


def decide(levels: dict, slots: torch.Tensor, bits: torch.Tensor):
    """``THRESHOLD_EST``'s linear-space scan (first minimum), then the
    error count."""
    mu0, mu1, s0, s1 = (levels[k] for k in ("mu0", "mu1", "s0", "s1"))
    r = np.linspace(mu0, mu1, 1000)

    def Q(x):
        return 0.5 * erfc(x / math.sqrt(2))
    rth = float(r[np.argmin(0.5 * (Q((mu1 - r) / s1) + Q((r - mu0) / s0)))])
    n_err = int(((slots > rth) != (bits > 0)).sum())
    return rth, n_err


def run(cfg: dict, traffic: dict, bits, draws: dict, device,
        precision: str = "float64") -> dict:
    """One waveform through the staged README chain; returns what
    :func:`plainlink.run` returns."""
    p = plainlink.Precision(precision)
    dev = torch.device(device)
    sps = cfg["params"]["sps"]
    b = torch.as_tensor(np.asarray(bits), device=dev)
    with torch.no_grad():
        A = transmit(cfg, b, draws, p, dev)
        A, steps = plainlink.channel(cfg, A, draws, p, dev)
        v = plainlink.receive(cfg, A, draws, p, dev)
        del A
        inst = cfg["link"]["sampler_instant"]
        slots = v[(sps // 2 if inst is None else inst)::sps]
        levels = plainlink.eye_levels(v, sps, traffic["nslots"],
                                      traffic["sps_resamp"], p)
        rth, n_err = decide(levels, slots, b)
    return dict(v=v, n_errors=n_err, threshold=rth, n_steps=steps, **levels)
