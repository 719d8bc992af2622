"""Plain reference of ``ppm8_20km`` (BASELINE config 3): M-PPM symbols
from the information bits -> the gaussian-pulse MZM transmitter -> 20 km
of the phi_max-adaptive split-step (the nonlinearity frozen at each step's
start) -> the optical band-pass -> the PIN with thermal and shot noise ->
the Bessel LPF -> upstream ``ppm.DSP``'s hard decision (ppm.py:309-415):
GET_EYE, the KDE-minimum threshold, SAMPLER at sps/2, the slicer, HDD and
the decoder, then the error count over the information bits.

Plain torch in float64 (``precision="bfloat16"``: the control, as in
:mod:`perfbench.reference.plainlink`); it imports nothing of the program
under test.  The transmitter, the fiber, the photodiode and LPF and the
eye's levels are :mod:`perfbench.reference.plainlink`'s; the unit-normal
draws are the benchmark's (``thermal``, ``shot``), and the HDD scores are
derived from the information bits as the entry driver derives them
(:mod:`perfbench.pbcore.ppm`).

Departures from upstream:

* HDD: upstream raises, for a symbol with no ON slot, a slot drawn with
  ``np.random``, and keeps one of several ON slots the same way; here every
  slot has a uniform score and each symbol takes the argmax of score +
  ON (first on a tie), which makes the same choices with the given scores.
* The band-pass is applied as its zero-phase ``|H|^2`` (upstream BPF,
  devices.py:788-826: ``sosfiltfilt`` of the Bessel low-pass at BW/2),
  circularly, in the frequency domain.
* The KDE is evaluated exactly (``scipy.stats.gaussian_kde``'s Scott rule,
  the sample standard deviation with one degree of freedom less) on the
  500 points between the levels; the eye's window is recomputed here
  (:func:`center_window`) because ``eye_levels`` returns only the levels.
* Where that threshold is undefined (fewer than two samples in the window,
  equal or non-finite levels), THRESHOLD_EST's 1000-point scan, in log
  space: the argmin of ``1 - Q((r-mu1)/s1) (1-Q((r-mu0)/s0))^(M-1)``.
* ``decision="soft"`` (the traffic's ``decision``): the per-symbol argmax
  of the slot samples; no eye, threshold or repair.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.pbcore.ppm import hdd_scores, info_bits
from perfbench.reference import plainlink as pl


def bandpass(cfg: dict, A: torch.Tensor, st: dict, p: pl.Precision, dev):
    """The optical band-pass ``st`` on the field ``A``: the zero-phase
    Bessel ``|H|^2`` of order ``n`` at ``BW/2``."""
    fs = cfg["params"]["R"] * cfg["params"]["sps"]
    H2 = torch.as_tensor(pl.bessel_h2(int(st["n"]), st["BW"] / 2, fs,
                                      A.shape[-1]), device=dev).to(p.real)
    return p.q(torch.fft.ifft(p.q(torch.fft.fft(A, dim=-1)) * H2, dim=-1))


def channel(cfg: dict, A: torch.Tensor, p: pl.Precision, dev):
    """The fiber and band-pass stages in order: ``(field, steps a fiber
    stage)``."""
    fs = cfg["params"]["R"] * cfg["params"]["sps"]
    w = pl._omega(A.shape[-1], fs)
    steps = []
    for st in cfg["link"]["stages"]:
        if st["spec"] == "FiberSpec":
            phi = torch.as_tensor(st["beta_2"] / 2 * w ** 2
                                  + st["beta_3"] / 6 * w ** 3,
                                  device=dev).to(p.real)
            A, k = pl.Fiber(st, phi, 1.0, p).run(A)
            steps.append(k)
        elif st["spec"] == "BPFSpec":
            A = bandpass(cfg, A, st, p, dev)
        else:
            raise NotImplementedError(st["spec"])
    return A, steps


def center_window(v: torch.Tensor, sps: int, nslots: int,
                  p: pl.Precision) -> torch.Tensor:
    """The samples of the eye's centre window, unresampled: the first
    ``nslots`` slots (whole pairs), rolled by ``-sps//2 + 1``, at the
    instants within 5 % of the crossing distance of the optimum instant
    (GET_EYE's steps 1-6, as ``plainlink.eye_levels`` takes them)."""
    n = v.numel()
    n -= n % (2 * sps)
    nslots = min(n // sps, int(nslots)) // 2 * 2
    y = p.q(torch.roll(v[:nslots * sps], -sps // 2 + 1))
    t = torch.as_tensor(np.kron(np.ones(nslots // 2),
                                np.linspace(-1, 1 - 1 / sps, 2 * sps)),
                        device=v.device).to(p.real)
    ys = torch.sort(y).values
    c0, c1 = pl._quantile(ys, 0.1), pl._quantile(ys, 0.9)
    for _ in range(32):
        lo = y <= (c0 + c1) / 2
        if 0 < int(lo.sum()) < y.numel() and bool(c0 != c1):
            c0, c1 = y[lo].mean(), y[~lo].mean()
    vm = (c0 + c1) / 2
    top, bot = y[y > vm], y[y < vm]
    state_1 = pl._half_interval_mid(top) if top.numel() > 2 else vm
    state_0 = pl._half_interval_mid(bot) if bot.numel() > 2 else vm
    d01 = state_1 - state_0
    v75, v25 = state_1 - 0.25 * d01, state_0 + 0.25 * d01
    mid = (state_0 + state_1) / 2
    band = (y > v25) & (y < v75)
    if int(band.sum()) < 2:
        return y[(-0.05 < t) & (t < 0.05)]
    tb, yb = t[band], y[band]
    cen = torch.stack([torch.stack([t.min(), mid]),
                       torch.stack([t.max(), mid])])
    for _ in range(32):
        d0 = (tb - cen[0, 0]) ** 2 + (yb - cen[0, 1]) ** 2
        d1 = (tb - cen[1, 0]) ** 2 + (yb - cen[1, 1]) ** 2
        in1 = d1 < d0
        cen = torch.stack([torch.stack([tb[sel].mean(), yb[sel].mean()])
                           if bool(sel.any()) else cen[k]
                           for k, sel in ((0, ~in1), (1, in1))])
    left = int(torch.argmin(cen[:, 0]))

    def nearest(x):
        return t[torch.argmin(torch.abs(t - x))]
    t_left, t_right = nearest(cen[left, 0]), nearest(cen[1 - left, 0])
    t_c = nearest(cen[:, 0].mean())
    t_dist = t_right - t_left
    return y[(t_c - 0.05 * t_dist < t) & (t < t_c + 0.05 * t_dist)]


def kde_threshold(y: torch.Tensor, mu0: float, mu1: float):
    """The minimum of the Gaussian KDE of ``y`` on 500 points from ``mu0``
    to ``mu1`` (upstream GET_EYE, devices.py:1852-1859); ``None`` where it
    is undefined."""
    y = y.to(torch.float64)
    n = y.numel()
    if n < 2 or not (math.isfinite(mu0) and math.isfinite(mu1)) \
            or mu0 == mu1:
        return None
    bw = float(y.std(correction=1)) * n ** (-1 / 5)
    if not bw > 0:
        return None
    grid = torch.linspace(mu0, mu1, 500, dtype=torch.float64,
                          device=y.device)
    z = (grid[:, None] - y[None, :]) / bw
    pdf = torch.exp(-0.5 * z * z).sum(1)
    return float(grid[int(torch.argmin(pdf))])


def scan_threshold(levels: dict, M: int, dev) -> float:
    """THRESHOLD_EST for M-PPM: the 1000-point scan between the levels of
    ``1 - Q((r-mu1)/s1) (1-Q((r-mu0)/s0))^(M-1)``, minimised as the
    maximum of its log-space complement."""
    mu0, mu1, s0, s1 = (levels[k] for k in ("mu0", "mu1", "s0", "s1"))
    r = torch.linspace(mu0, mu1, 1000, dtype=torch.float64, device=dev)
    log_a = (torch.special.log_ndtr((mu1 - r) / s1)
             + (M - 1) * torch.special.log_ndtr((r - mu0) / s0))
    return float(r[torch.argmax(log_a)])


def decode(positions: torch.Tensor, M: int) -> torch.Tensor:
    """ON-slot positions -> information bits, MSB first."""
    k = int(math.log2(M))
    shifts = torch.arange(k - 1, -1, -1, device=positions.device)
    return ((positions[:, None] >> shifts) & 1).reshape(-1)


def run(cfg: dict, traffic: dict, bits, draws: dict, device,
        precision: str = "float64") -> dict:
    """One waveform of ``traffic["M"]``-PPM through the link and the
    receiver ``traffic["decision"]``.  ``bits``: the call's pool row (one
    bit a slot; the first ``n_sym * log2(M)`` are sent).  Returns the
    voltage ``v`` (a tensor on ``device``), ``n_errors``, ``n_repaired``,
    ``threshold``, ``mu0``, ``mu1``, ``s0``, ``s1`` (``None`` for the soft
    decision) and ``n_steps`` (a list, one a fiber stage)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(cfg, traffic, bits, draws, torch.device(device),
                    pl.Precision(precision))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _run(cfg, traffic, bits, draws, dev, p) -> dict:
    M, sps = int(traffic["M"]), cfg["params"]["sps"]
    info = info_bits(bits, M)
    k = int(math.log2(M))
    sym = torch.as_tensor(info.reshape(-1, k).astype(np.int64), device=dev)
    pos = (sym * (2 ** torch.arange(k - 1, -1, -1, device=dev))).sum(1)
    slots_tx = torch.zeros((pos.numel(), M), dtype=torch.uint8, device=dev)
    slots_tx[torch.arange(pos.numel(), device=dev), pos] = 1
    with torch.no_grad():
        A = pl.transmit(cfg, slots_tx.reshape(-1), draws, p, dev)
        A, steps = channel(cfg, A, p, dev)
        v = pl.receive(cfg, A, draws, p, dev)
        del A
        inst = cfg["link"]["sampler_instant"]
        samp = v[(sps // 2 if inst is None else inst)::sps].reshape(-1, M)
        out = dict(v=v, n_steps=steps, n_repaired=None, threshold=None,
                   mu0=None, mu1=None, s0=None, s1=None)
        if traffic["decision"] == "soft":
            rx = torch.argmax(samp, dim=1)       # the first of equal maxima
        else:
            levels = pl.eye_levels(v, sps, traffic["nslots"], None, p)
            rth = kde_threshold(center_window(v, sps, traffic["nslots"], p),
                                levels["mu0"], levels["mu1"])
            if rth is None:
                rth = scan_threshold(levels, M, dev)
            on = (samp > rth).to(torch.int64)
            score = hdd_scores(info, M, dev).to(torch.float64) + on
            rx = torch.argmax(score, dim=1)
            out.update(levels, threshold=rth,
                       n_repaired=int((on.sum(1) != 1).sum()))
        rx_bits = decode(rx, M).cpu().numpy()
    return dict(out, n_errors=int((rx_bits != info).sum()))
