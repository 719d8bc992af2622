"""Eye-diagram metrology (port of ``opticomlib_tpu.ops.eyeana``; reference
devices.py:1635-1868), in two engines:

* :func:`eye_metrics`, the tensor twin of the JAX package's device engine
  ``eye_metrics_jax``, on the input's device;
* :func:`eye_metrics_host`, the JAX package's NumPy ``eye_metrics`` (the
  host engine of ``GET_EYE(engine="host")``) with its helpers
  :func:`kmeans2_1d`, :func:`kmeans2_2d` and :func:`kde_min_threshold`.

In the tensor engine every stage is a tensor reduction with static shapes:
subsets (level split, crossing band, centre window) are boolean masks,
dynamic-size sorts are full sorts with +inf padding, and the KDE threshold
is a fixed 4096-bin histogram
(:func:`opticomlib_tpu_torch.ops.kernels.histogram_rows`) contracted against
a Gaussian kernel matrix.  Nothing there reads back to the host or waits
for the card: a 0-d index is a device gather, a fallback a ``torch.where``
on a Python number, and the time axis is made once a shape
(:func:`_time_grid`), so the whole receiver queues behind the link on the
card.

:func:`eye_scalars`, the metrology without its traces (or with them,
``traces=True``), replays it on a CUDA input as one CUDA graph a shape
(:data:`GRAPH_COUNTS`): the same kernels in the same order as the eager
call, so the same bits.

A ``(C, n)`` input is ``C`` independent channels (the JAX package's ``vmap``
over ``eye_metrics_jax``): stages 1-6 run channel by channel on the rows, so
a row gives exactly what the 1-D call gives, and the KDE histograms of all
channels are one ``(C, 4096)`` kernel launch.

Integer sums that JAX keeps in int32 come out of torch as int64; where the
value feeds float arithmetic the port converts explicitly so the float32
results match (``_shortest_int_masked``).
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.analysis import _host, shortest_int
from . import kernels
from .pulses import resample_fft

__all__ = ["kmeans2_1d", "kmeans2_2d", "kde_min_threshold", "eye_metrics",
           "eye_metrics_host", "eye_window", "shortest_int_hist", "linspace",
           "eye_metrics_jax", "eye_metrics_jit"]

#: relative flatness tolerance of the KDE plateau diagnostic (same value as
#: ``opticomlib_tpu.ops.eyeana.PLATEAU_TOL``)
PLATEAU_TOL = 1e-3
_TINY = float(np.finfo(np.float32).tiny)
#: bins of the KDE threshold's histogram
_KDE_BINS = 4096
#: the rendering traces of :func:`eye_metrics`' result; the rest are scalars
#: (and the ``(2,)`` level intervals)
TRACE_KEYS = ("y", "t", "y_top", "y_bot", "y_25_75")


def _at(vals: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``vals[i]`` for a 0-d index tensor ``i``, gathered on the device:
    indexing by a 0-d tensor would read ``i`` back to the host."""
    return torch.index_select(vals, 0, i.reshape(1))[0]


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int):
    """``jnp.linspace`` on 0-d float32 tensors as XLA on the CPU evaluates
    it, so the two packages put grid points on the same floats.  XLA turns
    JAX's ``start*(1 - k/div) + stop*(k/div)`` into
    ``fma(k, stop*r, start*fma(-k, r, 1))`` with ``r = 1/div`` in float32;
    each fused multiply-add is emulated in float64 (the product is exact
    there) and rounded to float32 once.  The endpoint is ``stop`` exactly.
    Equal to ``jnp.linspace`` on ascending ranges; a descending range can
    differ at a few points by one ulp."""
    div = num - 1
    r = np.float32(1) / np.float32(div)
    k = torch.arange(div, dtype=torch.float64, device=start.device)
    one_minus = (1.0 - k * float(r)).to(torch.float32)        # fma(-k, r, 1)
    a = (stop * float(r)).to(torch.float64)
    b = (start * one_minus).to(torch.float64)
    out = (k * a + b).to(torch.float32)                       # fma(k, a, b)
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


def _lag(m: torch.Tensor, percent: float) -> torch.Tensor:
    """Window length of the shortest interval: ``m*percent/100`` in float32,
    as JAX promotes its int32 count with a Python float, then truncated.
    At ``m = 2^24`` the product's ulp is 128, so float32 matters."""
    return torch.clamp((m.to(torch.float32) * percent / 100.0).to(
        torch.int64), min=1)


def _shortest_int_masked(y, mask, percent: float = 50.0):
    """Shortest interval holding ``percent`` % of the masked samples.
    Non-members sort to +inf; ties resolve to the floor-mean index."""
    n = y.numel()
    ys = torch.sort(torch.where(mask, y, torch.inf)).values
    m = mask.sum()
    lag = _lag(m, percent)
    idx = torch.arange(n, device=y.device)
    hi = ys[torch.clamp(idx + lag, 0, n - 1)]
    valid = (idx + lag) < m
    diff = torch.where(valid, hi - ys, torch.inf)
    dmin = diff.min()
    tie = valid & (torch.abs(diff - dmin) < 1e-10)
    n_tie = torch.clamp(tie.sum(), min=1)
    i = torch.where(tie, idx, 0).sum() // n_tie
    return _at(ys, i), _at(ys, torch.clamp(i + lag, 0, n - 1))


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


def _kde_min_thresholds(chans, npts: int = 500, nbins: int = _KDE_BINS):
    """Scott's-rule Gaussian KDE over each channel's masked window, on an
    ``npts`` grid between its two levels, via a histogram contraction.
    ``chans``: a list of ``(y, mask, mu0, mu1)`` with 1-D ``y`` of one
    length; the histograms of all channels are one ``(C, nbins)`` launch.
    Returns a list of ``(threshold, plateau_width)``.  The (npts x nbins)
    contraction is an elementwise product and a sum in full float32, so no
    TF32 matrix path (about three digits) can reach the density."""
    prep = []
    for y, mask, mu0, mu1 in chans:
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
        # masked samples fall out of range
        prep.append((torch.where(mask, bins, -1), n_win, bw, lo, width))
    hists = kernels.histogram_rows(torch.stack([p[0] for p in prep]), nbins)

    out = []
    for (y, mask, mu0, mu1), (_, n_win, bw, lo, width), hist in zip(
            chans, prep, hists):
        centers = lo + (torch.arange(nbins, dtype=torch.float32,
                                     device=y.device) + 0.5) / nbins * width
        grid = linspace(mu0, mu1, npts)
        z = (grid[:, None] - centers[None, :]) / bw
        pdf = (torch.exp(-0.5 * z * z) * hist).sum(-1)
        thr = _at(grid, torch.argmin(pdf))
        ok = ((n_win >= 2) & torch.isfinite(mu0) & torch.isfinite(mu1)
              & (mu0 != mu1) & (bw > 0))
        rng = pdf.max() - pdf.min()
        flat = pdf <= pdf.min() + PLATEAU_TOL * torch.clamp(rng, min=_TINY)
        dg = torch.abs(grid[1] - grid[0])
        plateau = flat.sum().to(torch.float32) * dg
        out.append((torch.where(ok, thr, torch.nan),
                    torch.where(ok, plateau, torch.nan)))
    return out


def shortest_int_hist(y: torch.Tensor, percent: float = 99.99,
                      nbins: int = 8192, reduce_sum=None, reduce_min=None,
                      reduce_max=None):
    """Shortest interval holding ``percent`` % of the samples, from a
    fixed-bin histogram and no global sort, so it composes with a sample
    axis split over devices: pass collectives over that axis as the
    ``reduce_*`` hooks and each device contributes its local block.  The
    bounds land on bin edges (port of
    ``opticomlib_tpu.ops.eyeana.shortest_int_hist``).

    ``y``: (..., n) real or complex (the real part counts); leading axes are
    independent channels, whose histograms are one
    :func:`~opticomlib_tpu_torch.ops.kernels.histogram_rows` launch.
    Returns ``(lo, hi)`` of shape ``y.shape[:-1]``."""
    ident = (lambda x: x)
    reduce_sum = reduce_sum or ident
    reduce_min = reduce_min or ident
    reduce_max = reduce_max or ident

    y = (y.real if y.is_complex() else y).to(torch.float32)
    lead = y.shape[:-1]
    lo_g = reduce_min(y.min(dim=-1).values)
    hi_g = reduce_max(y.max(dim=-1).values)
    width = torch.clamp(hi_g - lo_g, min=_TINY)
    idx = torch.clamp(((y - lo_g[..., None]) / width[..., None]
                       * nbins).to(torch.int32), 0, nbins - 1)
    hist = kernels.histogram_rows(
        idx.reshape(-1, y.shape[-1]).contiguous(), nbins).reshape(
            lead + (nbins,))
    hist = reduce_sum(hist)

    cum = torch.cumsum(hist, dim=-1)                 # inclusive
    total = cum[..., -1:]
    lag = torch.clamp(total * float(np.float32(percent / 100.0)), min=1.0)
    target = (cum - hist) + lag                      # count before b, + lag
    e = torch.searchsorted(cum, target.contiguous())  # first cum >= target
    valid = e < nbins                                # lag samples fit from b
    e_c = torch.clamp(e, 0, nbins - 1)
    bw = (width / nbins)[..., None]
    left = lo_g[..., None] + torch.arange(
        nbins, dtype=torch.float32, device=y.device) * bw
    right = lo_g[..., None] + (e_c + 1).to(torch.float32) * bw
    w_int = torch.where(valid, right - left, torch.inf)
    b_star = torch.argmin(w_int, dim=-1, keepdim=True)
    return (torch.gather(left, -1, b_star)[..., 0],
            torch.gather(right, -1, b_star)[..., 0])


def _nearest(vals, x):
    return _at(vals, torch.argmin(torch.abs(vals - x)))


def eye_window(n: int, sps: int, nslots: int) -> int:
    """Samples of an ``n``-sample waveform that :func:`eye_metrics` looks at:
    whole slot pairs, at most ``nslots`` slots, from the start."""
    n -= n % (2 * sps)
    return min(n // sps, int(nslots)) // 2 * 2 * sps


def eye_metrics(samples: torch.Tensor, sps: int, nslots: int = 4096,
                sps_resamp: Optional[int] = None) -> dict:
    """Blind eye metrology of a sampled waveform (8-stage pipeline of the
    reference GET_EYE): the counterpart of the JAX package's device engine
    ``eye_metrics_jax`` (:func:`eye_metrics_host` is that of its NumPy
    ``eye_metrics``).  Returns a dict of 0-d tensors plus the traces
    ``t``/``y``/``y_top``/``y_bot``/``y_25_75``, all on the input's
    device.  A ``(C, n)`` input is ``C`` channels: every tensor of the
    result gains a leading channel axis, and row ``c`` equals the 1-D call
    on ``samples[c]``.  Always eager (:func:`eye_scalars` is the graphed
    call without the traces)."""
    rows = samples if samples.ndim == 2 else samples.reshape(1, -1)
    outs = _eye_rows(rows, sps, nslots, sps_resamp, traces=True)
    if samples.ndim == 2:
        return _stacked(outs)
    out = outs[0]
    out["t"] = out["t"].clone()  # not the cached grid itself
    return out


#: the JAX package's names of its device engine, the jittable function and
#: its compiled entry point: here both are :func:`eye_metrics` (the same
#: arguments; nothing to compile)
eye_metrics_jax = eye_metrics_jit = eye_metrics


def _eye_rows(rows: torch.Tensor, sps: int, nslots: int,
              sps_resamp: Optional[int], traces: bool) -> list:
    """Stages 1-8 on each row of ``rows`` ``(C, n)``: a dict a row."""
    outs = [_eye_stages(row, sps, nslots, sps_resamp, traces)
            for row in rows]
    # 7. KDE threshold + plateau-width diagnostic, all channels in one launch
    kde = _kde_min_thresholds([o.pop("_kde") for o in outs])
    for out, (thr, plateau) in zip(outs, kde):
        out["threshold"], out["threshold_plateau"] = thr, plateau
        # 8. ER and eye opening
        mu0, mu1 = out["mu0"], out["mu1"]
        out["er"] = torch.where(
            mu0 > 0, 10 * torch.log10(mu1 / mu0),
            torch.where(mu0 == 0, torch.inf, torch.nan))
        out["eye_h"] = mu1 - 3 * out["s1"] - mu0 - 3 * out["s0"]
    return outs


def _stacked(outs: list) -> dict:
    return {k: (torch.stack([o[k] for o in outs])
                if isinstance(v, torch.Tensor) else v)
            for k, v in outs[0].items()}


def _time_grid(nslots: int, sps: int, device: torch.device) -> torch.Tensor:
    """The eye's time axis, two slots of ``sps`` samples folded ``nslots //
    2`` times: the host engine's float64 grid rounded to float32, copied to
    ``device`` once a ``(nslots, sps, device)`` (the last
    :data:`GRAPH_CACHE` kept)."""
    key = (nslots, sps, device)
    t = _grids.pop(key, None)
    if t is None:
        t = np.kron(np.ones(nslots // 2), np.linspace(-1, 1 - 1 / sps, 2 * sps))
        t = torch.as_tensor(t.astype(np.float32), device=device)
    _grids[key] = t
    if len(_grids) > GRAPH_CACHE:
        _grids.popitem(last=False)
    return t


def _eye_stages(samples: torch.Tensor, sps: int, nslots: int,
                sps_resamp: Optional[int], traces: bool) -> dict:
    """Stages 1-6 of :func:`eye_metrics` on one channel (the traces only
    with ``traces``); ``"_kde"`` holds stage 7's input ``(y, window, mu0,
    mu1)``."""
    y_in = (samples.real if samples.is_complex() else samples).reshape(
        -1).to(torch.float32)
    out: dict = {"sps": sps}

    # 1. truncation and centering
    nslots = eye_window(int(y_in.shape[0]), sps, nslots) // sps
    y_in = y_in[: nslots * sps]
    y_in = torch.roll(y_in, -sps // 2 + 1)  # floor division, as the host

    # 2. optional FFT resampling
    if sps_resamp:
        y = resample_fft(y_in, nslots * sps_resamp).to(
            torch.float32).contiguous()
        out["sps_resamp"] = sps_resamp
    else:
        y = y_in
    t = _time_grid(nslots, sps_resamp or sps, samples.device)
    if traces:
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

    def _or(value, fallback: float):
        return torch.where(have_cross, value, fallback)

    t_left = _or(_nearest(t, _at(ty_c[:, 0], left)), -0.5)
    t_right = _or(_nearest(t, _at(ty_c[:, 0], right)), 0.5)
    t_center = _or(_nearest(t, ty_c[:, 0].mean()), 0.0)
    out["t_left"] = t_left
    out["t_right"] = t_right
    out["t_opt"] = t_center
    # nearest-value lookups snap to the pre-resample sample values
    out["y_left"] = _or(_nearest(y_in, _at(ty_c[:, 1], left)), np.nan)
    out["y_right"] = _or(_nearest(y_in, _at(ty_c[:, 1], right)), np.nan)
    if traces:
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
    if traces:
        out["y_top"] = torch.where(top_sel, y, torch.nan)
        out["y_bot"] = torch.where(bot_sel, y, torch.nan)

    out["mu1"] = mu1 = _masked_mean(y, top_sel)
    out["s1"] = s1 = _masked_std(y, top_sel)
    out["mu0"] = mu0 = _masked_mean(y, bot_sel)
    out["s0"] = s0 = _masked_std(y, bot_sel)

    out["_kde"] = (y, window, mu0, mu1)
    return out


# ---------------------------------------------------------------------------
# the scalars alone, replayed as a CUDA graph
# ---------------------------------------------------------------------------
#: receiver calls (:func:`eye_scalars`) served by a CUDA graph captured in
#: the call, by a replay of one, and eagerly (a CPU input, a shape's first
#: call, a shape whose capture raised, a call inside someone's capture)
GRAPH_COUNTS = {"captured": 0, "replayed": 0, "eager": 0}
#: graphs (and time grids) kept at once; the least recently used goes first
GRAPH_CACHE = 8
_COUNTED = {"capture": "captured", "replay": "replayed", "eager": "eager"}
_SEEN = "seen"               # a shape's first call ran eagerly
_graphs: OrderedDict = OrderedDict()   # key -> _SEEN or _Graph
_no_graph: set = set()                 # keys whose capture raised
_grids: OrderedDict = OrderedDict()
_capture_streams: dict = {}


class EyeScalars(NamedTuple):
    """What :func:`eye_scalars` returns."""
    #: the scalars as tensors (a leading channel axis for a ``(C, n)``
    #: input) and the ints ``sps`` / ``sps_resamp``
    m: dict
    #: the same tensors packed as float64 ``(C, K)`` rows, and the layout
    #: :func:`unpack_rows` takes: one copy reads them all back
    rows: torch.Tensor
    layout: list
    #: ``"replay"``, ``"capture"`` or ``"eager"``
    how: str


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static_in: torch.Tensor
    out: tuple          # (m, rows, layout) in the graph's memory pool
    launches: dict      # kernels.LAUNCHES a replay makes
    held: tuple         # what the graph reads outside its pool


def pack_rows(cols: dict):
    """Per-channel results (tensors with a leading channel axis) as one
    ``(C, K)`` float64 tensor, so that one copy reads them back, and a mesh
    gathers them, in one go; returns it with the layout
    :func:`unpack_rows` takes."""
    flat, layout = [], []
    for k, v in cols.items():
        layout.append((k, tuple(v.shape[1:]), v.dtype))
        flat.append(v.reshape(v.shape[0], -1).to(torch.float64))
    return torch.cat(flat, dim=1), layout


def unpack_rows(host: np.ndarray, layout) -> dict:
    """The columns of :func:`pack_rows`' rows (read back) as NumPy arrays
    of their shapes and dtypes."""
    out, j = {}, 0
    for k, shape, dtype in layout:
        w = int(np.prod(shape))
        out[k] = host[:, j:j + w].reshape((len(host),) + shape).astype(
            torch.empty(0, dtype=dtype).numpy().dtype)
        j += w
    return out


def _scalar_rows(win: torch.Tensor, sps: int, nslots: int,
                 sps_resamp: Optional[int], traces: bool = False) -> tuple:
    """Stages 1-8 on the rows of the eye window ``win``, the traces only
    with ``traces``: ``(m, rows, layout)`` of :class:`EyeScalars` (the
    traces are not packed)."""
    m = _stacked(_eye_rows(win, sps, nslots, sps_resamp, traces=traces))
    rows, layout = pack_rows({k: v for k, v in m.items()
                              if isinstance(v, torch.Tensor)
                              and k not in TRACE_KEYS})
    return m, rows, layout


def eye_scalars(samples: torch.Tensor, sps: int, nslots: int = 4096,
                sps_resamp: Optional[int] = None,
                traces: bool = False) -> EyeScalars:
    """:func:`eye_metrics` without its traces: the same scalars, bit for
    bit, as tensors and packed in float64 rows (:class:`EyeScalars`).
    ``traces=True``: ``m`` holds :func:`eye_metrics`' traces too, from the
    same graph (they are not in the packed rows).

    On a CUDA input that no one is capturing, the metrology of each input
    shape (device, rows, window, dtype, ``sps``, ``nslots``,
    ``sps_resamp``) runs eagerly on its first call, is captured as a CUDA
    graph on its second, and from then on is one copy of the eye window
    into the graph's input and one graph launch, with no read-back.  The
    tensors returned from a graph live in its memory pool: the next call
    of that shape overwrites them.  The last :data:`GRAPH_CACHE` shapes
    keep a graph; a shape whose capture raises stays eager (it warns
    once).  A CPU input runs eagerly.  :data:`GRAPH_COUNTS` counts each
    way."""
    rows = samples if samples.ndim == 2 else samples.reshape(1, -1)
    win = rows[:, :eye_window(int(rows.shape[1]), sps, nslots)]
    graph, how = None, "eager"
    if win.is_cuda and not torch.cuda.is_current_stream_capturing():
        graph, how = _graph_for(win, sps, nslots, sps_resamp, traces)
    if graph is None:
        m, packed, layout = _scalar_rows(win, sps, nslots, sps_resamp,
                                         traces)
    else:
        graph.static_in.copy_(win)
        graph.graph.replay()
        for k, n in graph.launches.items():
            kernels.LAUNCHES[k] += n
        m, packed, layout = graph.out
    GRAPH_COUNTS[_COUNTED[how]] += 1
    if samples.ndim != 2:
        m = {k: v[0] if isinstance(v, torch.Tensor) else v
             for k, v in m.items()}
    return EyeScalars(m, packed, layout, how)


def _graph_for(win: torch.Tensor, sps: int, nslots: int,
               sps_resamp: Optional[int], traces: bool) -> tuple:
    """The graph of ``win``'s shape (with or without the traces) and how
    this call uses it: ``(None, "eager")`` on the shape's first call and
    for a shape whose capture raised, ``(graph, "capture")`` on its second,
    ``(graph, "replay")`` after."""
    key = (win.device, tuple(win.shape), win.dtype, sps, nslots, sps_resamp,
           traces)
    if key in _no_graph:
        return None, "eager"
    entry = _graphs.get(key)
    if entry is None:
        _graphs[key] = _SEEN
        if len(_graphs) > GRAPH_CACHE:
            _graphs.popitem(last=False)
        return None, "eager"
    _graphs.move_to_end(key)
    if entry is not _SEEN:
        return entry, "replay"
    try:
        entry = _graphs[key] = _capture(win, sps, nslots, sps_resamp,
                                        traces)
    except Exception as exc:  # noqa: BLE001 - whatever refused the capture
        del _graphs[key]
        _no_graph.add(key)
        warnings.warn(f"eye_scalars: no CUDA graph for {key} ({exc!r}); "
                      f"that shape runs eagerly", RuntimeWarning,
                      stacklevel=3)
        return None, "eager"
    return entry, "capture"


def _capture(win: torch.Tensor, sps: int, nslots: int,
             sps_resamp: Optional[int], traces: bool) -> _Graph:
    """Capture :func:`_scalar_rows` on an input of ``win``'s shape, on a
    side stream of ``win``'s device, into a graph of its own pool.  Nothing
    runs; the caller replays it.  What the graph reads outside its pool
    (the time grid, the histogram scratch) is made first, and held."""
    dev = win.device
    static_in = torch.empty(win.shape, dtype=win.dtype, device=dev)
    stream = _capture_streams.get(dev)
    if stream is None:
        stream = _capture_streams[dev] = torch.cuda.Stream(dev)
    grid = _time_grid(win.shape[1] // sps, sps_resamp or sps, dev)
    scratch = kernels.histogram_rows_scratch(win.shape[0], _KDE_BINS, dev,
                                             stream)
    stream.wait_stream(torch.cuda.current_stream(dev))
    before = dict(kernels.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.no_grad(), torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = _scalar_rows(static_in, sps, nslots, sps_resamp,
                                   traces)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
    finally:
        launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items()}
        kernels.LAUNCHES.update(before)  # the capture launched nothing
    torch.cuda.current_stream(dev).wait_stream(stream)
    return _Graph(graph, static_in, out, launches, (grid, scratch))


# ---------------------------------------------------------------------------
# the host engine: NumPy, copied from the JAX package's ``eye_metrics``
# ---------------------------------------------------------------------------
def kmeans2_1d(y: np.ndarray, iters: int = 32):
    """Two-cluster Lloyd's algorithm on scalars.

    Deterministic initialization at the 10/90 percentiles; for bimodal eye
    amplitude data this converges to the same partition as sklearn's
    multi-restart KMeans (which the reference uses at devices.py:1757-1760).
    Returns (c0, c1) cluster centers, c0 <= c1.
    """
    y = np.asarray(_host(y), dtype=np.float64).ravel()
    c0, c1 = np.quantile(y, 0.1), np.quantile(y, 0.9)
    if c0 == c1:
        return c0, c1
    for _ in range(iters):
        mid = 0.5 * (c0 + c1)
        lo = y <= mid
        n_lo = lo.sum()
        if n_lo == 0 or n_lo == y.size:
            break
        c0n = y[lo].mean()
        c1n = y[~lo].mean()
        if c0n == c0 and c1n == c1:
            break
        c0, c1 = c0n, c1n
    return float(c0), float(c1)


def kmeans2_2d(pts: np.ndarray, init: np.ndarray, iters: int = 32):
    """Two-cluster Lloyd's algorithm in 2-D (used on the (t, y) crossing
    band, reference devices.py:1782-1798).  Returns (2, 2) centers."""
    pts = np.asarray(_host(pts), dtype=np.float64)
    centers = np.asarray(_host(init), dtype=np.float64).copy()
    for _ in range(iters):
        d = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        lab = d.argmin(1)
        new = centers.copy()
        for k in (0, 1):
            sel = lab == k
            if sel.any():
                new[k] = pts[sel].mean(0)
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def _plateau_width_np(grid: np.ndarray, pdf: np.ndarray) -> float:
    rng = pdf.max() - pdf.min()
    flat = pdf <= pdf.min() + PLATEAU_TOL * max(rng, 1e-300)
    dg = grid[1] - grid[0] if grid.size > 1 else 0.0
    return float(flat.sum() * abs(dg))


def kde_min_threshold(y: np.ndarray, mu0: float, mu1: float,
                      npts: int = 500, nbins: int = 4096,
                      return_plateau: bool = False):
    """Decision threshold at the minimum of the amplitude density between
    the two levels (reference devices.py:1852-1859).

    Bandwidth: Scott's rule ``n**(-1/5) * std(y)``, the default of
    ``scipy.stats.gaussian_kde``.  The density is a fine histogram convolved
    with the Gaussian kernel (the argmin of the exact KDE up to the bin
    width).  ``return_plateau=True`` also returns the width of the flat
    density region around the minimum (see :data:`PLATEAU_TOL`).
    """
    y = np.asarray(_host(y), dtype=np.float64).ravel()
    bad = (y.size < 2 or not np.all(np.isfinite([mu0, mu1]))
           or mu0 == mu1)
    bw = y.std() * y.size ** (-1 / 5) if not bad else 0.0
    if bad or bw <= 0:
        return (None, None) if return_plateau else None

    lo_g, hi_g = min(mu0, mu1), max(mu0, mu1)
    lo = min(y.min(), lo_g) - 5 * bw
    hi = max(y.max(), hi_g) + 5 * bw
    hist, edges = np.histogram(y, bins=nbins, range=(lo, hi))
    centers = 0.5 * (edges[:-1] + edges[1:])
    db_ = edges[1] - edges[0]

    # Gaussian smoothing of the histogram = KDE sampled at bin centers
    half = int(np.ceil(5 * bw / db_))
    k = np.exp(-0.5 * (np.arange(-half, half + 1) * db_ / bw) ** 2)
    pdf_bins = np.convolve(hist.astype(np.float64), k, mode="same")

    grid = np.linspace(mu0, mu1, npts)
    pdf = np.interp(grid, centers, pdf_bins)
    thr = float(grid[int(pdf.argmin())])
    if return_plateau:
        return thr, _plateau_width_np(grid, pdf)
    return thr


def _find_nearest(levels: np.ndarray, value):
    levels = np.asarray(levels)
    return levels[np.abs(levels - value).argmin()]


def eye_metrics_host(input_samples, sps: int, nslots: int = 4096,
                     sps_resamp: Optional[int] = None) -> dict:
    """The host engine: the JAX package's NumPy ``eye_metrics`` (the
    counterpart of the JAX host engine; :func:`eye_metrics` is that of
    ``eye_metrics_jax``).  ``input_samples``: an array or a tensor on any
    device, taken to the host in float64.  Returns a dict of Python
    numbers and NumPy traces.

    Mirrors the reference pipeline step by step
    (reference devices.py:1635-1868):

    1.  truncate to a multiple of ``2*sps`` slots, cap at ``nslots``, roll by
        ``-sps//2 + 1`` to center the eye;
    2.  optional FFT resampling to ``sps_resamp`` samples/slot;
    3.  2-means split of the amplitudes -> inter-level midpoint ``vm``;
    4.  shortest-50%-interval means above/below ``vm`` -> level LMS
        estimates ``state_1`` / ``state_0``;
    5.  25-75% crossing band -> 2-means on (t, y) -> ``t_left``/``t_right``/
        ``t_opt``;
    6.  +-5%-of-eye-width window at ``t_opt`` -> ``mu0/mu1/s0/s1``;
    7.  KDE minimum between the levels -> ``threshold``;
    8.  extinction ratio and eye height.
    """
    y_in = np.asarray(_host(input_samples)).real.astype(np.float64).ravel()
    out: dict = {"sps": sps}

    # 1. truncation and centering (devices.py:1731-1740)
    rem = y_in.size % (2 * sps)
    if rem:
        y_in = y_in[:-rem]
    # traces fold two slots each, so the slot count must be even (an odd
    # user nslots would make t one slot shorter than y)
    nslots = min(int(y_in.size // sps), int(nslots)) // 2 * 2
    y_in = y_in[: nslots * sps]
    y_in = np.roll(y_in, -sps // 2 + 1)
    y_set = np.unique(y_in)

    # 2. optional resampling (devices.py:1744-1751)
    if sps_resamp:
        y = resample_fft(torch.from_numpy(y_in),
                         nslots * sps_resamp).numpy().astype(np.float64)
        out["sps_resamp"] = sps_resamp
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps_resamp, 2 * sps_resamp))
    else:
        y = y_in
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps, 2 * sps))
    out["y"] = y
    out["t"] = t

    # 3. amplitude bi-level split (devices.py:1757-1760)
    c0, c1 = kmeans2_1d(y)
    vm = 0.5 * (c0 + c1)

    # 4. level estimates (devices.py:1763-1769)
    top = y[y > vm]
    bot = y[y < vm]
    out["top_int"] = top_int = (shortest_int(top, 50) if top.size > 2
                                else np.array([vm, vm]))
    out["bot_int"] = bot_int = (shortest_int(bot, 50) if bot.size > 2
                                else np.array([vm, vm]))
    state_1 = float(np.mean(top_int))
    state_0 = float(np.mean(bot_int))
    d01 = state_1 - state_0
    v75 = state_1 - 0.25 * d01
    v25 = state_0 + 0.25 * d01
    t_set = np.unique(t)

    # 5. crossing times (devices.py:1782-1798)
    cond = (y > v25) & (y < v75)
    try:
        if cond.sum() < 2:
            raise ValueError("no crossing samples")
        ty = np.stack([t[cond], y[cond]], axis=1)
        init = np.array([[t.min(), 0.5 * (state_0 + state_1)],
                         [t.max(), 0.5 * (state_0 + state_1)]])
        ty_c = kmeans2_2d(ty, init)
        left = int(ty_c[:, 0].argmin())
        right = int(ty_c[:, 0].argmax())
        out["t_left"] = t_left = float(_find_nearest(t_set, ty_c[left, 0]))
        out["t_right"] = t_right = float(_find_nearest(t_set, ty_c[right, 0]))
        out["t_opt"] = t_center = float(_find_nearest(t_set, ty_c[:, 0].mean()))
        out["y_left"] = float(_find_nearest(y_set, ty_c[left, 1]))
        out["y_right"] = float(_find_nearest(y_set, ty_c[right, 1]))
        y_25_75 = y.copy()
        y_25_75[~cond] = np.nan
        out["y_25_75"] = y_25_75
    except ValueError:
        out["t_left"] = t_left = -0.5
        out["t_right"] = t_right = 0.5
        out["t_opt"] = t_center = 0.0
        out["y_left"] = None
        out["y_right"] = None

    # 6. center-window statistics (devices.py:1800-1849)
    out["t_dist"] = t_dist = t_right - t_left
    out["t_span0"] = t_span0 = t_center - 0.05 * t_dist
    out["t_span1"] = t_span1 = t_center + 0.05 * t_dist
    y_center = _find_nearest(y_set, 0.5 * (state_0 + state_1))

    if sps_resamp:
        instant = int(np.abs(t - t_center).argmin()) - sps_resamp // 2 + 1
        instant = int(instant / sps_resamp * sps)
    else:
        instant = int(np.abs(t - t_center).argmin()) - sps // 2 + 1
    out["i"] = instant

    window = (t_span0 < t) & (t < t_span1)
    top_sel = (y > y_center) & window
    bot_sel = (y < y_center) & window

    y_top = np.where(top_sel, y, np.nan)
    y_bot = np.where(bot_sel, y, np.nan)
    out["y_top"] = y_top
    out["y_bot"] = y_bot

    out["mu1"] = mu1 = float(np.nanmean(y_top)) if top_sel.any() else np.nan
    out["s1"] = s1 = float(np.nanstd(y_top)) if top_sel.any() else np.nan
    out["mu0"] = mu0 = float(np.nanmean(y_bot)) if bot_sel.any() else np.nan
    out["s0"] = s0 = float(np.nanstd(y_bot)) if bot_sel.any() else np.nan

    # 7. KDE threshold (devices.py:1852-1859) + plateau-width diagnostic
    y_win = y[window]
    thr, plateau = (kde_min_threshold(y_win, mu0, mu1,
                                      return_plateau=True)
                    if np.isfinite([mu0, mu1]).all() else (None, None))
    out["threshold"] = thr
    out["threshold_plateau"] = plateau

    # 8. ER and eye opening (devices.py:1862-1865)
    out["er"] = (10 * np.log10(mu1 / mu0) if mu0 > 0
                 else np.inf if mu0 == 0 else np.nan)
    out["eye_h"] = mu1 - 3 * s1 - mu0 - 3 * s0
    return out
