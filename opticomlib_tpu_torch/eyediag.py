"""Eye-diagram result container (copied from ``opticomlib_tpu.eyediag``)
and the counts behind its density rendering: :func:`eye_density` bins a
trace pair into the ``(nbins, nbins)`` occupancy map of
``eyediagram_density`` / ``Eye.plot`` on the traces' device, through the
``histogram2d`` kernel, and :meth:`Eye.density` folds an eye's traces as
``Eye.plot`` does before binning them.  The Matplotlib drawing itself
(``Eye.plot``, ``eyediagram``) is not ported yet."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops import kernels

__all__ = ["Eye", "eye", "eye_density"]


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


# reference-compatible lowercase alias
eye = Eye
