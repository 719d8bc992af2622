"""Eye-diagram result object and rendering (port of
``opticomlib_tpu.eyediag``; reference typing.py:2440-2809 and
utils.py:1593-1787).

:func:`eye_density` bins a trace pair into the ``(nbins, nbins)`` occupancy
map of :func:`eyediagram_density` / :meth:`Eye.plot` on the traces' device,
through the ``histogram2d`` kernel on a card, and :meth:`Eye.density` folds
an eye's traces as ``Eye.plot`` does before binning them.  The drawing
(``Eye.plot``, ``eyediagram_density``, ``eyediagram``) is host Matplotlib
and SciPy smoothing of those counts; Matplotlib is imported when a drawing
is asked for.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops import kernels
from .utils.analysis import _host

__all__ = ["Eye", "eye", "EyeShowOptions", "eye_density",
           "eyediagram_density", "eyediagram"]


class EyeShowOptions:
    """Flag bundle for eye plot annotations (reference typing.py:2440-2456).

    Each option defaults to ``all_none`` (so ``EyeShowOptions()`` shows a
    bare eye and ``EyeShowOptions(all_none=True)`` turns everything on) —
    field-for-field parity with the reference, including the quirk that
    the reference's plot docstring claims "default show all" while its
    code defaults everything off.
    """

    def __init__(self, averages: Optional[bool] = None,
                 threshold: Optional[bool] = None,
                 cross_points: Optional[bool] = None,
                 legends: Optional[bool] = None,
                 t_opt: Optional[bool] = None,
                 histogram: Optional[bool] = None,
                 all_none: bool = False):
        self.averages = averages if averages is not None else all_none
        self.threshold = threshold if threshold is not None else all_none
        self.cross_points = (cross_points if cross_points is not None
                             else all_none)
        self.legends = legends if legends is not None else all_none
        self.t_opt = t_opt if t_opt is not None else all_none
        self.histogram = histogram if histogram is not None else all_none


def _edges(x: torch.Tensor, nbins: int) -> np.ndarray:
    """``nbins`` equal bins over the finite range of ``x`` as
    ``np.histogram2d`` lays them: float64, a flat range widened by 0.5
    either side."""
    lo, hi = (float(v) for v in torch.stack([x.min(), x.max()]).tolist())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return np.linspace(lo, hi, nbins + 1)


def _bin_index(x: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """Bin of each sample on ``edges`` by ``np.histogram2d``'s rule (left
    edge inclusive, the last bin's right edge too), int32; -1 where the
    sample is not finite."""
    e = torch.as_tensor(edges, device=x.device)
    idx = torch.searchsorted(e, x, right=True) - 1
    idx = torch.where(x == e[-1], idx - 1, idx)
    return torch.where(torch.isfinite(x), idx, -1).to(torch.int32)


def eye_density(t, y, nbins: int = 256):
    """Occupancy counts of the points ``(t, y)`` on an ``nbins x nbins``
    grid over their range: what ``np.histogram2d(t, y, bins=nbins)`` returns
    for the float64 values of the finite pairs, computed on the traces'
    device (the counts by the ``histogram2d`` kernel on a card).  Returns
    ``(H, t_edges, y_edges)``: ``H`` a float32 ``(nbins, nbins)`` tensor on
    that device, the edges float64 NumPy arrays."""
    t = torch.as_tensor(t).reshape(-1).to(torch.float64)
    y = torch.as_tensor(y, device=t.device).reshape(-1).to(torch.float64)
    ok = torch.isfinite(t) & torch.isfinite(y)
    if not bool(ok.any()):
        raise ValueError("eye_density needs at least one finite (t, y) pair")
    te = _edges(t[ok], nbins)
    ye = _edges(y[ok], nbins)
    ti = torch.where(ok, _bin_index(t, te), -1)
    yi = torch.where(ok, _bin_index(y, ye), -1)
    return kernels.histogram2d(ti, yi, nbins, nbins), te, ye


class Eye:
    """Eye-diagram parameters and metrics.

    Attributes (same names/meanings as the reference): ``t``, ``y`` traces,
    ``t_left/t_right/t_opt`` crossing times, ``mu0/mu1/s0/s1`` level stats,
    ``er`` extinction ratio [dB], ``eye_h`` eye opening, ``threshold``
    optimal decision threshold, ``i`` optimum sampling instant, ``sps``.
    """

    def __init__(self, params: Optional[dict] = None, **kwargs):
        params = dict(params or {})
        params.update(kwargs)
        self.__dict__.update(params)
        self.execution_time = params.get("execution_time", 0.0)

    def __getattr__(self, name):
        # undefined metrology fields read as None (reference tolerates
        # partially-filled eye dicts, e.g. tests/ook_test.py MockEye)
        if name.startswith("__"):
            raise AttributeError(name)
        return None

    def __str__(self, title: Optional[str] = None):
        title = title or "eye diagram parameters"
        head = 3 * "*" + f"    {title}    " + 3 * "*"
        sub = len(head) * "-"

        def fmt(v):
            if v is None:
                return "None"
            if isinstance(v, float):
                return f"{v:.4e}"
            return str(v)

        fields = ["t_left", "t_right", "t_opt", "t_dist", "mu0", "mu1",
                  "s0", "s1", "er", "eye_h", "threshold", "i", "sps"]
        body = "\n".join(f"\t{k:10s}:  {fmt(getattr(self, k))}"
                         for k in fields)
        return f"\n{sub}\n{head}\n{sub}\n{body}\n"

    def print(self, msg: Optional[str] = None):
        if msg:
            print(msg)
        print(self)
        return self

    def density(self, nbins: int = 256):
        """The counts ``Eye.plot`` renders, from this eye's traces: the
        trace folded into whole two-slot windows and binned on an
        ``nbins x nbins`` grid (:func:`eye_density`), and the amplitude
        histogram, on the same amplitude bins, of the samples within 5 % of
        the crossing distance of ``t_opt``.  Returns ``(occ, t_edges,
        y_edges, hy)`` with ``occ`` ``(nbins, nbins)`` and ``hy``
        ``(nbins,)`` float32 tensors on the traces' device."""
        if self.empty:
            raise ValueError("this Eye carries no traces (ask for them: "
                             "LinkProgram.eye(with_traces=True) or GET_EYE)")
        sps = int(self.sps_resamp or self.sps)
        y = torch.as_tensor(self.y)
        y = torch.roll(y, -sps // 2)[sps // 2:-sps // 2]
        t = torch.as_tensor(self.t, device=y.device)[:-sps]
        occ, te, ye = eye_density(t, y, nbins)
        t_opt = self.t_opt if self.t_opt is not None else 0.5
        t_dist = self.t_dist if self.t_dist is not None else 1.0
        sel = torch.abs(t - t_opt) <= 0.05 * t_dist
        yi = torch.where(sel, _bin_index(y.to(torch.float64), ye), -1)
        hy = kernels.histogram_rows(yi.reshape(1, -1), nbins)[0]
        return occ, te, ye, hy

    @property
    def empty(self) -> bool:
        """True when the object carries no trace data."""
        return self.__dict__.get("y") is None

    def plot(self, show_options: Optional[EyeShowOptions] = None,
             hlines: Optional[list] = None, vlines: Optional[list] = None,
             style: str = "dark", cmap: str = "winter", smooth: bool = True,
             title: str = "", savefig: Optional[str] = None,
             ax=None):
        """Annotated eye-diagram plot (reference typing.py:2577-2798).

        Same knobs as the reference: ``show_options`` annotation flags
        (t_opt span lines, crossing points, threshold, level means,
        side histogram, legends), user ``hlines``/``vlines``, dark/light
        ``style``, smoothed-density or per-trace rendering (``smooth``),
        ``savefig`` path (``.png`` at 300 dpi), external ``ax``.
        """
        import matplotlib.pyplot as plt
        from contextlib import nullcontext
        from scipy.ndimage import gaussian_filter

        show_options = show_options or EyeShowOptions()
        hlines = hlines or []
        vlines = vlines or []
        if self.empty:
            raise ValueError("Empty eye diagram object.")

        if style == "dark":
            style_context = "dark_background"
            t_opt_color, means_color = "#60FF86", "white"
        elif style == "light":
            style_context = "default"
            t_opt_color, means_color = "green", "#5A5A5A"
        else:
            raise TypeError(
                "The `style` argument must be one of the following values "
                "('dark', 'light')")

        dt = self.dt or 0.0
        style_mgr = (plt.style.context(style_context) if ax is None
                     else nullcontext())

        with style_mgr:
            if show_options.histogram:
                fig, ax = plt.subplots(
                    1, 2, gridspec_kw={"width_ratios": [4, 1],
                                       "wspace": 0.03}, figsize=(8, 5))
            elif ax is None:
                fig, ax = plt.subplots(1, 1)
                ax = [ax, ax]
            else:
                ax = [ax, ax]

            if title:
                plt.suptitle(f"Eye diagram {title}")

            ax[0].set_xlim(-1 - dt, 1)
            moments = [self.mu0, self.mu1, self.s0, self.s1]
            if (all(m is not None for m in moments)
                    and np.isfinite(np.asarray(moments, dtype=float)).all()):
                ax[0].set_ylim(self.mu0 - 4 * self.s0,
                               self.mu1 + 4 * self.s1)
            ax[0].set_ylabel(r"Amplitude [V]", fontsize=12)
            ax[0].grid(color="grey", ls="--", lw=0.5, alpha=0.5)
            ax[0].set_xticks([-1, -0.5, 0, 0.5, 1])
            ax[0].set_xlabel(r"Time [$t/T_{slot}$]", fontsize=12)

            if show_options.t_opt and self.t_opt is not None:
                ax[0].axvline(self.t_opt, color=t_opt_color, ls="--",
                              alpha=0.7)
                if self.t_span0 is not None and self.t_span1 is not None:
                    ax[0].axvline(self.t_span0, color=t_opt_color, ls="-",
                                  alpha=0.4)
                    ax[0].axvline(self.t_span1, color=t_opt_color, ls="-",
                                  alpha=0.4)

            if (show_options.cross_points and self.y_right is not None
                    and self.y_left is not None):
                ax[0].plot([self.t_left, self.t_right],
                           [self.y_left, self.y_right], "xr")

            if show_options.threshold and self.threshold is not None:
                ax[0].axhline(self.threshold, c="r", ls="--")
                if show_options.histogram:
                    ax[1].axhline(self.threshold, c="r", ls="--", label="th")
                    if show_options.legends:
                        ax[1].legend()

            for hl in hlines:
                ax[0].axhline(hl, c="y")
                if show_options.histogram:
                    ax[1].axhline(hl, c="y")
            for vl in vlines:
                ax[0].axvline(vl, c="y")
                if show_options.histogram:
                    ax[1].axvline(vl, c="y")

            if show_options.legends:
                ax[0].legend([r"$t_{opt}$"], fontsize=12, loc="upper right")

            if (show_options.averages and self.mu0 is not None
                    and self.mu1 is not None):
                ax[0].axhline(self.mu1, color=means_color, ls=":", alpha=0.7)
                ax[0].axhline(self.mu0, color=means_color, ls="-.",
                              alpha=0.7)
                if show_options.histogram:
                    ax[1].axhline(self.mu1, color=means_color, ls=":",
                                  alpha=0.7, label=r"$\mu_1$")
                    ax[1].axhline(self.mu0, color=means_color, ls="-.",
                                  alpha=0.7, label=r"$\mu_0$")
                    if show_options.legends:
                        ax[1].legend()

            if show_options.histogram:
                ax[1].sharey(ax[0])
                ax[1].tick_params(axis="x", which="both", length=0,
                                  labelbottom=False)
                ax[1].tick_params(axis="y", which="both", length=0,
                                  labelleft=False)
                ax[1].grid(color="grey", ls="--", lw=0.5, alpha=0.5)

            # --- density rendering ---
            # Fold the trace into two-slot windows (drop the half-slot
            # roll-in/out so every window is complete) and rasterize an
            # occupancy map on a 256x256 grid — enough that one grid cell
            # is well below a slot width at any plot size.  The traces
            # carry sps_resamp samples/slot when GET_EYE interpolated.
            # The counts come from :meth:`density` (the histogram2d kernel
            # where the traces lie on a card).
            sps = int(self.sps_resamp or self.sps)
            y_ = np.roll(np.asarray(_host(self.y)),
                         -sps // 2)[sps // 2:-sps // 2]
            t_ = np.asarray(_host(self.t))[:-sps]

            NB = 256
            occ, te, ye, hy = self.density(NB)
            occ = occ.cpu().numpy().astype(np.float64)
            occ_s = gaussian_filter(occ, sigma=NB / 128)  # ~2-cell blur

            if smooth:
                # Translucency tracks the density itself: transparent
                # where no trace passes, opaque from the 99.5th-percentile
                # occupancy up (so a few hot crossing pixels don't wash
                # out the rails); sqrt response lifts the faint tails.
                pos = occ_s[occ_s > 0]
                hi = np.quantile(pos, 0.995) if pos.size else 1.0
                a_map = np.sqrt(np.clip(occ_s / max(hi, 1e-30), 0.0, 1.0))
                ax[0].imshow(occ_s.T, origin="lower", aspect="auto",
                             extent=(te[0], te[-1], ye[0], ye[-1]),
                             alpha=a_map.T, cmap=cmap,
                             interpolation="bilinear")
            else:
                # per-trace polylines, colored by the occupancy under each
                # segment midpoint — all traces in ONE LineCollection
                from matplotlib.collections import LineCollection

                win = 2 * sps
                ntr = y_.size // win
                tt = t_[:win]
                Y = y_[:ntr * win].reshape(ntr, win)
                tm = np.broadcast_to(0.5 * (tt[:-1] + tt[1:]),
                                     (ntr, win - 1))
                ym = 0.5 * (Y[:, :-1] + Y[:, 1:])
                it = np.clip(np.searchsorted(te, tm) - 1, 0, NB - 1)
                iy = np.clip(np.searchsorted(ye, ym) - 1, 0, NB - 1)
                c = occ_s[it, iy]
                c = c / c.max() if c.max() > 0 else c
                pts = np.stack([np.broadcast_to(tt, Y.shape), Y], axis=-1)
                segs = np.stack([pts[:, :-1], pts[:, 1:]],
                                axis=2).reshape(-1, 2, 2)
                ax[0].add_collection(LineCollection(
                    segs, colors=plt.get_cmap(cmap)(c.ravel()),
                    linewidth=1, alpha=0.06))

            if show_options.histogram:
                # amplitude histogram of the samples inside the optimum
                # decision window |t - t_opt| <= 5% of the crossing
                # distance (the window GET_EYE derives mu/sigma from)
                hy = gaussian_filter(hy.cpu().numpy().astype(np.float64),
                                     sigma=NB / 128)
                ax[1].plot(hy, 0.5 * (ye[:-1] + ye[1:]),
                           color=t_opt_color)

            if savefig:
                if savefig.endswith(".png"):
                    plt.savefig(savefig, dpi=300)
                else:
                    plt.savefig(savefig)

        return self

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()
        return self


def eyediagram_density(t, y, ax=None, nbins: int = 256, sigma: float = 2.0,
                       cmap: str = "inferno"):
    """Density-colored eye rendering: 2-D histogram + Gaussian smoothing
    (reference utils.py:1593-1787 'density' style).  The counts are
    :func:`eye_density`'s, on the device of ``t`` (a tensor or an array),
    the smoothing SciPy's on the host."""
    import matplotlib.pyplot as plt
    from scipy.ndimage import gaussian_filter

    H, xe, ye = eye_density(t, y, nbins)
    H = gaussian_filter(H.cpu().numpy().astype(np.float64), sigma)
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(H.T, origin="lower", aspect="auto", cmap=cmap,
              extent=[xe[0], xe[-1], ye[0], ye[-1]])
    return ax


def eyediagram(y, sps, n_traces=None, cmap="viridis", N_grid_bins=200,
               grid_sigma=5, style="dot", ax=None,
               **plot_kw):
    """Standalone eye plot of a waveform (reference utils.py:1593-1787);
    ``y``: an array or a tensor on any device."""
    import matplotlib.pyplot as plt

    y = np.asarray(_host(y)).real.ravel()
    n = (y.size // (2 * sps)) * 2 * sps
    y = y[:n]
    ntr = n // (2 * sps)
    if n_traces:
        ntr = min(ntr, n_traces)
    traces = y[: ntr * 2 * sps].reshape(ntr, 2 * sps)
    t = np.linspace(-1, 1 - 1 / sps, 2 * sps)
    if ax is None:
        _, ax = plt.subplots()
    if style == "density":
        eyediagram_density(np.tile(t, ntr), traces.ravel(), ax=ax,
                           nbins=N_grid_bins, sigma=grid_sigma, cmap=cmap)
    else:
        fmt = "." if style == "dot" else "-"
        ax.plot(t, traces.T, fmt, ms=1, alpha=0.3, **plot_kw)
    ax.set_xlabel("t / T_slot")
    return ax


# reference-compatible lowercase alias
eye = Eye
