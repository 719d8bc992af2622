"""Eye-diagram metrology on the device (port of the device twin
``opticomlib_tpu.ops.eyeana.eye_metrics_jax``; reference
devices.py:1635-1868).

Every stage is a tensor reduction with static shapes: subsets (level split,
crossing band, centre window) are boolean masks, dynamic-size sorts are full
sorts with +inf padding, and the KDE threshold is a fixed 4096-bin histogram
(:func:`opticomlib_tpu_torch.ops.kernels.histogram2d`) contracted against a
Gaussian kernel matrix.  Nothing here reads back to the host, so the whole
receiver queues behind the link on the card.

Integer sums that JAX keeps in int32 come out of torch as int64; where the
value feeds float arithmetic the port converts explicitly so the float32
results match (``_shortest_int_masked``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import kernels
from .pulses import resample_fft

__all__ = ["eye_metrics", "linspace"]

#: relative flatness tolerance of the KDE plateau diagnostic (same value as
#: ``opticomlib_tpu.ops.eyeana.PLATEAU_TOL``)
PLATEAU_TOL = 1e-3
_TINY = float(np.finfo(np.float32).tiny)


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int):
    """``jnp.linspace`` on 0-d float32 tensors, with JAX's arithmetic
    (``start*(1-s) + stop*s`` with ``s = k/(num-1)``, exact endpoint), so
    the two packages put grid points on the same floats."""
    div = num - 1
    step = torch.from_numpy(
        np.arange(div, dtype=np.float32) / np.float32(div)).to(start.device)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _masked_mean(x, mask):
    c = mask.sum()
    return torch.where(c > 0, torch.where(mask, x, 0.0).sum()
                       / torch.clamp(c, min=1), torch.nan)


def _masked_std(x, mask):
    m = _masked_mean(x, mask)
    return torch.sqrt(_masked_mean((x - m) ** 2, mask))


def _quantiles(y: torch.Tensor, qs) -> list:
    """Linear-interpolated quantiles by one sort (``torch.quantile`` refuses
    more than 2^24 elements), with ``jnp.quantile``'s float32 arithmetic."""
    ys = torch.sort(y).values
    n = y.numel()
    out = []
    for q in qs:
        pos = np.float32(q) * np.float32(n - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        w_hi = np.float32(pos - np.float32(lo))
        w_lo = np.float32(1) - w_hi
        v = ys[lo] * float(w_lo) + ys[hi] * float(w_hi)
        # jnp.quantile: any NaN gives NaN (torch sorts NaN last)
        out.append(torch.where(torch.isnan(ys[-1]), torch.nan, v))
    return out


def _kmeans2_1d(y, iters: int = 32):
    """Two-cluster Lloyd iterations on scalars, 10/90 % quantile init, a
    fixed iteration count (extra iterations after convergence are no-ops)."""
    c0, c1 = _quantiles(y, (0.1, 0.9))
    for _ in range(iters):
        mid = 0.5 * (c0 + c1)
        lo = y <= mid
        n_lo = lo.sum()
        ok = (n_lo > 0) & (n_lo < y.numel()) & (c0 != c1)
        c0, c1 = (torch.where(ok, _masked_mean(y, lo), c0),
                  torch.where(ok, _masked_mean(y, ~lo), c1))
    return c0, c1


def _shortest_int_masked(y, mask, percent: float = 50.0):
    """Shortest interval holding ``percent`` % of the masked samples.
    Non-members sort to +inf; ties resolve to the floor-mean index."""
    n = y.numel()
    ys = torch.sort(torch.where(mask, y, torch.inf)).values
    m = mask.sum()
    # float32 like JAX's int32 * python-float promotion, then truncation
    lag = torch.clamp((m.to(torch.float32) * percent / 100.0).to(torch.int64),
                      min=1)
    idx = torch.arange(n, device=y.device)
    hi = ys[torch.clamp(idx + lag, 0, n - 1)]
    valid = (idx + lag) < m
    diff = torch.where(valid, hi - ys, torch.inf)
    dmin = diff.min()
    tie = valid & (torch.abs(diff - dmin) < 1e-10)
    n_tie = torch.clamp(tie.sum(), min=1)
    i = torch.where(tie, idx, 0).sum() // n_tie
    return ys[i], ys[torch.clamp(i + lag, 0, n - 1)]


def _kmeans2_2d(t, y, mask, init, iters: int = 32):
    """Two-cluster Lloyd iterations on the masked (t, y) points."""
    centers = init
    for _ in range(iters):
        d0 = (t - centers[0, 0]) ** 2 + (y - centers[0, 1]) ** 2
        d1 = (t - centers[1, 0]) ** 2 + (y - centers[1, 1]) ** 2
        in1 = d1 < d0
        m0 = mask & ~in1
        m1 = mask & in1
        c0 = torch.where(m0.sum() > 0, torch.stack(
            [_masked_mean(t, m0), _masked_mean(y, m0)]), centers[0])
        c1 = torch.where(m1.sum() > 0, torch.stack(
            [_masked_mean(t, m1), _masked_mean(y, m1)]), centers[1])
        centers = torch.stack([c0, c1])
    return centers


def _kde_min_threshold(y, mask, mu0, mu1, npts: int = 500,
                       nbins: int = 4096):
    """Scott's-rule Gaussian KDE over the masked window, on an ``npts`` grid
    between the two levels, via a histogram contraction.  Returns
    ``(threshold, plateau_width)``.  The (npts x nbins) contraction is an
    elementwise product and a sum in full float32, so no TF32 matrix path
    (about three digits) can reach the density."""
    n_win = mask.sum()
    bw = _masked_std(y, mask) * torch.clamp(n_win, min=1).to(
        torch.float32) ** (-1 / 5)
    y_lo = torch.where(mask, y, torch.inf).min()
    y_hi = torch.where(mask, y, -torch.inf).max()
    lo = torch.minimum(y_lo, torch.minimum(mu0, mu1)) - 5 * bw
    hi = torch.maximum(y_hi, torch.maximum(mu0, mu1)) + 5 * bw
    width = torch.clamp(hi - lo, min=_TINY)

    bins = torch.clamp(((y - lo) / width * nbins).to(torch.int32), 0,
                       nbins - 1)
    bins = torch.where(mask, bins, -1)  # masked samples fall out of range
    hist = kernels.histogram2d(torch.zeros_like(bins), bins, 1, nbins)[0]
    centers = lo + (torch.arange(nbins, dtype=torch.float32,
                                 device=y.device) + 0.5) / nbins * width

    grid = linspace(mu0, mu1, npts)
    z = (grid[:, None] - centers[None, :]) / bw
    pdf = (torch.exp(-0.5 * z * z) * hist).sum(-1)
    thr = grid[torch.argmin(pdf)]
    ok = ((n_win >= 2) & torch.isfinite(mu0) & torch.isfinite(mu1)
          & (mu0 != mu1) & (bw > 0))
    rng = pdf.max() - pdf.min()
    flat = pdf <= pdf.min() + PLATEAU_TOL * torch.clamp(rng, min=_TINY)
    dg = torch.abs(grid[1] - grid[0])
    plateau = flat.sum().to(torch.float32) * dg
    return (torch.where(ok, thr, torch.nan),
            torch.where(ok, plateau, torch.nan))


def _nearest(vals, x):
    return vals[torch.argmin(torch.abs(vals - x))]


def eye_metrics(samples: torch.Tensor, sps: int, nslots: int = 4096,
                sps_resamp: Optional[int] = None) -> dict:
    """Blind eye metrology of a sampled waveform (8-stage pipeline of the
    reference GET_EYE).  Returns a dict of 0-d tensors plus the traces
    ``t``/``y``/``y_top``/``y_bot``/``y_25_75``, all on the input's
    device."""
    dev = samples.device
    y_in = (samples.real if samples.is_complex() else samples).reshape(
        -1).to(torch.float32)
    out: dict = {"sps": sps}
    n0 = int(y_in.shape[0])

    # 1. truncation and centering
    rem = n0 % (2 * sps)
    if rem:
        y_in = y_in[:-rem]
    nslots = min(int(y_in.shape[0] // sps), int(nslots)) // 2 * 2
    y_in = y_in[: nslots * sps]
    y_in = torch.roll(y_in, -sps // 2 + 1)  # floor division, as the host

    # 2. optional FFT resampling
    if sps_resamp:
        y = resample_fft(y_in, nslots * sps_resamp).to(
            torch.float32).contiguous()
        out["sps_resamp"] = sps_resamp
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps_resamp, 2 * sps_resamp))
    else:
        y = y_in
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps, 2 * sps))
    t = torch.as_tensor(t.astype(np.float32), device=dev)
    out["y"] = y
    out["t"] = t

    # 3. amplitude bi-level split
    c0, c1 = _kmeans2_1d(y)
    vm = 0.5 * (c0 + c1)

    # 4. level estimates (masked shortest-50%-interval)
    top_m = y > vm
    bot_m = y < vm
    ti0, ti1 = _shortest_int_masked(y, top_m, 50)
    bi0, bi1 = _shortest_int_masked(y, bot_m, 50)
    top_ok = top_m.sum() > 2
    bot_ok = bot_m.sum() > 2
    ti0, ti1 = torch.where(top_ok, ti0, vm), torch.where(top_ok, ti1, vm)
    bi0, bi1 = torch.where(bot_ok, bi0, vm), torch.where(bot_ok, bi1, vm)
    out["top_int"] = torch.stack([ti0, ti1])
    out["bot_int"] = torch.stack([bi0, bi1])
    state_1 = 0.5 * (ti0 + ti1)
    state_0 = 0.5 * (bi0 + bi1)
    d01 = state_1 - state_0
    v75 = state_1 - 0.25 * d01
    v25 = state_0 + 0.25 * d01

    # 5. crossing times (masked 2-means on the 25-75% band)
    cond = (y > v25) & (y < v75)
    have_cross = cond.sum() >= 2
    mid_lv = 0.5 * (state_0 + state_1)
    init = torch.stack([torch.stack([t.min(), mid_lv]),
                        torch.stack([t.max(), mid_lv])])
    ty_c = _kmeans2_2d(t, y, cond, init)
    left = torch.argmin(ty_c[:, 0])
    right = 1 - left

    def _or(value, fallback):
        return torch.where(have_cross, value,
                           torch.tensor(fallback, dtype=torch.float32,
                                        device=dev))

    t_left = _or(_nearest(t, ty_c[left, 0]), -0.5)
    t_right = _or(_nearest(t, ty_c[right, 0]), 0.5)
    t_center = _or(_nearest(t, ty_c[:, 0].mean()), 0.0)
    out["t_left"] = t_left
    out["t_right"] = t_right
    out["t_opt"] = t_center
    # nearest-value lookups snap to the pre-resample sample values
    out["y_left"] = _or(_nearest(y_in, ty_c[left, 1]), np.nan)
    out["y_right"] = _or(_nearest(y_in, ty_c[right, 1]), np.nan)
    out["y_25_75"] = torch.where(cond, y, torch.nan)

    # 6. center-window statistics
    t_dist = t_right - t_left
    t_span0 = t_center - 0.05 * t_dist
    t_span1 = t_center + 0.05 * t_dist
    out["t_dist"] = t_dist
    out["t_span0"] = t_span0
    out["t_span1"] = t_span1
    y_center = _nearest(y_in, mid_lv)

    i_min = torch.argmin(torch.abs(t - t_center))
    if sps_resamp:
        q = (i_min - sps_resamp // 2 + 1) * sps
        # truncate toward zero (host: int(q / sps_resamp)), not floor
        instant = torch.sign(q) * (torch.abs(q) // sps_resamp)
    else:
        instant = i_min - sps // 2 + 1
    out["i"] = instant

    window = (t_span0 < t) & (t < t_span1)
    top_sel = (y > y_center) & window
    bot_sel = (y < y_center) & window
    out["y_top"] = torch.where(top_sel, y, torch.nan)
    out["y_bot"] = torch.where(bot_sel, y, torch.nan)

    out["mu1"] = mu1 = _masked_mean(y, top_sel)
    out["s1"] = s1 = _masked_std(y, top_sel)
    out["mu0"] = mu0 = _masked_mean(y, bot_sel)
    out["s0"] = s0 = _masked_std(y, bot_sel)

    # 7. KDE threshold + plateau-width diagnostic
    out["threshold"], out["threshold_plateau"] = _kde_min_threshold(
        y, window, mu0, mu1)

    # 8. ER and eye opening
    out["er"] = torch.where(
        mu0 > 0, 10 * torch.log10(mu1 / mu0),
        torch.where(mu0 == 0, torch.inf, torch.nan))
    out["eye_h"] = mu1 - 3 * s1 - mu0 - 3 * s0
    return out
