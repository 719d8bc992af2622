"""Plain reference of the fused OOK link: bits -> DAC -> laser and MZM ->
fiber spans (split-step), EDFAs and DBP -> photodiode -> Bessel LPF ->
ADC -> eye metrology -> threshold -> slicer -> error count.

Written from the link's equations in plain torch (and SciPy for the Bessel
design, NumPy for the pulse taps); it imports nothing of the program under
test and takes nothing the program made.  The configuration is the JSON
dict of ``perfbench/configs/<name>.json``; the unit-normal noise draws are
the ones the benchmark hands to both sides, by name (``phase``, ``rin``,
one ``(4, n)`` ``ase`` a noisy EDFA in run order, ``thermal``, ``shot``).

``precision="float64"`` is the reference: every array in float64 /
complex128.  ``precision="bfloat16"`` is the control: float32 arithmetic
with every intermediate field, voltage and receiver sample rounded to
bfloat16, the step below the float32 that the configurations state.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import scipy.signal as sg
import torch
from scipy.constants import c as C_LIGHT, e as Q_E, h as H_PLANCK, k as K_B

_DB_PER_NEPER = 10.0 / math.log(10.0)   # dB/km -> 1/km divisor
_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))  # Yoshida triple jump
_W0 = 1.0 - 2.0 * _W1


def idb(x):
    return 10.0 ** (x / 10.0)


class Precision:
    """The arithmetic of one side: ``q`` rounds a result to the storage
    precision (a no-op for float64)."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        wide = name == "float64"
        self.real = torch.float64 if wide else torch.float32
        self.cplx = torch.complex128 if wide else torch.complex64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float64":
            return x
        if x.is_complex():
            r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
            return torch.view_as_complex(r.contiguous())
        return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# transmitter
# ---------------------------------------------------------------------------
def pulse_spectrum(link: dict, sps: int, n: int) -> np.ndarray:
    """Spectrum of the DAC's pulse, centred at index 0 (zero phase), for a
    length-``n`` circular convolution."""
    pk = link["pulse_kwargs"]
    if link["pulse_shape"] != "gaussian" or pk["c"] != 0:
        raise NotImplementedError("only the unchirped gaussian pulse")
    return _gauss_spectrum(int(link["pulse_span"]), float(pk["T"]),
                           int(pk["m"]), sps, n)


@lru_cache(maxsize=4)
def _gauss_spectrum(span: int, T: float, m: int, sps: int, n: int):
    t = np.linspace(-span / 2, span / 2, span * sps + 1)
    a = 2 * np.sqrt(np.log(2)) / T
    h = np.exp(-((a * t) ** (2 * m)))
    buf = np.zeros(n)
    buf[:h.size] = h
    return np.fft.fft(np.roll(buf, -((h.size - 1) // 2)))


def transmit(cfg: dict, bits: torch.Tensor, draws: dict, p: Precision,
             dev) -> torch.Tensor:
    """DAC -> laser -> MZM: the launch field ``(n,)``."""
    link, sps = cfg["link"], cfg["params"]["sps"]
    fs = cfg["params"]["R"] * sps
    n = bits.numel() * sps
    xu = torch.zeros((bits.numel(), sps), dtype=p.real, device=dev)
    xu[:, sps // 2] = bits.to(p.real)
    Hp = torch.as_tensor(pulse_spectrum(link, sps, n), device=dev).to(p.cplx)
    x = p.q(torch.fft.ifft(torch.fft.fft(xu.reshape(-1)) * Hp).real)
    x = p.q(x * link["Vpp"] + link["offset"])
    if link["coupling"].upper() == "AC":
        x = p.q(x - x.mean())

    amp0 = math.sqrt(idb(link["P0"]) * 1e-3)
    amp = torch.full((n,), amp0, dtype=p.real, device=dev)
    phase = torch.zeros((n,), dtype=p.real, device=dev)
    if link["lw"]:
        sigma = math.sqrt(2 * math.pi * link["lw"] / fs)
        phase = p.q(torch.cumsum(draws["phase"].to(p.real) * sigma, 0))
    if link["rin"] is not None:
        sigma = math.sqrt(idb(link["rin"]) * fs)
        amp = p.q(torch.sqrt(torch.clamp(
            1 + draws["rin"].to(p.real) * sigma, min=0.0)) * amp0)
    if link["df"]:
        raise NotImplementedError("frequency offset")
    E = p.q(torch.polar(amp, phase))
    if link["modulator"] != "mzm":
        raise NotImplementedError("only the MZM")
    g = (x + link["bias"]) * (math.pi / 2 / link["Vpi"])
    eta = math.sqrt(idb(-link["ER_dB"]))
    loss = math.sqrt(idb(-link["loss_dB"]))
    h = p.q(torch.complex(torch.cos(g), torch.sin(g) * eta) * loss)
    return p.q(E * h)


# ---------------------------------------------------------------------------
# fiber, amplifier, back-propagation
# ---------------------------------------------------------------------------
def _step_schedule(length: float, h: float) -> list:
    n_full = int(math.floor(length / h + 1e-9))
    rem = length - n_full * h
    hs = [h] * n_full
    if rem > 1e-9 * max(length, 1.0):
        hs.append(rem)
    return hs or [length]


class Fiber:
    """One span of the NLSE, forward (``sgn`` 1) or back-propagated
    (``sgn`` -1: every operator's sign flipped)."""

    def __init__(self, st: dict, phi: torch.Tensor, sgn: float,
                 p: Precision):
        self.st, self.p = st, p
        self.phi = phi * sgn                        # rad/km
        self.a = sgn * st["alpha"] / _DB_PER_NEPER  # 1/km
        self.g = sgn * st["gamma"]

    def lin(self, A, h):
        """Linear substep: ``ifft(fft(A) * exp(-a h/2 + i phi h))``."""
        E = torch.polar(torch.full_like(self.phi, math.exp(-self.a * h / 2)),
                        self.phi * h)
        q = self.p.q
        return q(torch.fft.ifft(q(q(torch.fft.fft(A, dim=-1)) * E), dim=-1))

    def kick(self, A, c):
        """``A exp(i c |A|^2)`` and the rotation."""
        P = A.real ** 2 + A.imag ** 2
        H = self.p.q(torch.polar(torch.ones_like(P), P * c))
        return self.p.q(A * H), H

    def frozen_step(self, A, h):
        """Symmetric NL-L-NL step, the nonlinearity frozen at the step's
        start."""
        B, H = self.kick(A, self.g * h / 2)
        return self.p.q(self.lin(B, h) * H)

    def strang(self, A, h):
        A = self.kick(A, self.g * h / 2)[0]
        return self.kick(self.lin(A, h), self.g * h / 2)[0]

    def o4(self, A, h):
        for w in (_W1, _W0, _W1):
            A = self.strang(A, h * w)
        return A

    def run(self, A):
        """Returns ``(A, steps)``."""
        st = self.st
        st_len = st["length"]
        if st["h"] is not None:
            hs = _step_schedule(st_len, st["h"])
            step = self.o4 if st["method"] == "o4" else self.frozen_step
            if st["method"] not in ("o4", "reference"):
                raise NotImplementedError(st["method"])
            for h in hs:
                A = step(A, h)
            return A, len(hs)
        if st["method"] != "reference" or self.g == 0:
            raise NotImplementedError("adaptive: the reference scheme only")
        # phi_max-adaptive: each step sized so that the peak nonlinear
        # phase is phi_max, from the field's peak power
        phi_max = st["phi_max"]

        def peak(A):
            return float((A.real ** 2 + A.imag ** 2).max())
        z, steps = 0.0, 0
        h = min(phi_max / (abs(self.g) * peak(A)), st_len)
        h_floor = st_len * 1.5e-7
        while z < st_len:
            z += h
            A = self.frozen_step(A, h)
            h = max(min(phi_max / (abs(self.g) * peak(A)), st_len - z),
                    h_floor)
            steps += 1
        return A, steps


def _flat_stages(stages: list):
    """The stages in run order, repeats unrolled; a ``("promote",)`` marker
    before a repeat block that holds a noisy EDFA."""
    for st in stages:
        if st["spec"] == "RepeatSpec":
            if any(s["spec"] == "EDFASpec" and s.get("NF") is not None
                   for s in st["stages"]):
                yield {"spec": "promote"}
            for _ in range(st["n"]):
                yield from st["stages"]
        else:
            yield st


@lru_cache(maxsize=4)
def _omega(n: int, fs: float) -> np.ndarray:
    """Angular frequency of each FFT bin [rad/ps]."""
    return 2 * np.pi * np.fft.fftfreq(n) * fs * 1e-12


def _two_pol(A):
    if A.ndim == 2:
        return A
    return torch.stack([A, torch.zeros_like(A)])


def channel(cfg: dict, A: torch.Tensor, draws: dict, p: Precision, dev):
    """The channel stages: returns ``(field, steps a fiber stage)``."""
    fs = cfg["params"]["R"] * cfg["params"]["sps"]
    f0 = C_LIGHT / cfg["params"]["wavelength"]
    n = A.shape[-1]
    w = _omega(n, fs)
    phis = {}
    steps, i_ase = [], 0
    for st in _flat_stages(cfg["link"]["stages"]):
        kind = st["spec"]
        if kind == "promote":
            A = _two_pol(A)
        elif kind in ("FiberSpec", "DBPSpec"):
            key = (st["beta_2"], st["beta_3"])
            if key not in phis:
                phis[key] = torch.as_tensor(
                    st["beta_2"] / 2 * w ** 2 + st["beta_3"] / 6 * w ** 3,
                    device=dev).to(p.real)
            sgn = 1.0
            if kind == "DBPSpec":
                sgn = -1.0
                A = p.q(A * math.sqrt(idb(-st["undo_gain_dB"])))
            A, k = Fiber(st, phis[key], sgn, p).run(A)
            steps.append(k)
        elif kind == "EDFASpec":
            G = idb(st["G"])
            A = p.q(_two_pol(A) * math.sqrt(G))
            if st.get("NF") is not None:
                sigma = math.sqrt(idb(st["NF"]) * H_PLANCK * f0 * (G - 1)
                                  * fs / 4)
                d = draws["ase"][i_ase].to(p.real) * sigma
                i_ase += 1
                A = p.q(A + torch.complex(d[:2], d[2:]))
            if st.get("BW") is not None:
                raise NotImplementedError("EDFA output filter")
        else:
            raise NotImplementedError(kind)
    return A, steps


# ---------------------------------------------------------------------------
# photodiode, LPF, ADC
# ---------------------------------------------------------------------------
@lru_cache(maxsize=4)
def bessel_h2(order: int, BW: float, fs: float, n: int) -> np.ndarray:
    """Zero-phase response ``|H|^2`` of the Bessel low-pass
    (``sosfiltfilt`` of ``bessel(order, BW, norm='mag')``)."""
    sos = sg.bessel(N=order, Wn=BW, btype="low", fs=fs, output="sos",
                    norm="mag")
    _, H = sg.sosfreqz(sos, worN=n, fs=fs, whole=True)
    return np.abs(H) ** 2


def shortest_interval(y: torch.Tensor, percent: float):
    """Shortest interval holding ``percent`` % of the samples (ties: the
    floor of the mean index)."""
    ys = torch.sort(y.reshape(-1)).values
    n = ys.numel()
    lag = max(int(n * percent / 100.0), 1)
    diff = ys[lag:] - ys[:n - lag]
    tie = torch.nonzero(diff == diff.min()).reshape(-1)
    i = int(tie.sum()) // tie.numel()
    return ys[i], ys[i + lag]


def receive(cfg: dict, A: torch.Tensor, draws: dict, p: Precision, dev):
    """Photodiode -> LPF -> ADC: the voltage ``(n,)``."""
    link = cfg["link"]
    fs = cfg["params"]["R"] * cfg["params"]["sps"]
    n = A.shape[-1]
    P = A.real ** 2 + A.imag ** 2
    if P.ndim == 2:
        P = P.sum(0)
    i_ph = p.q(P * link["pd_r"])
    i = i_ph
    if link["include_thermal"] or link["include_shot"]:
        i = i + link["i_dark"]
    if link["include_thermal"]:
        S_T = 4 * K_B * link["pd_T"] * fs / 2 * idb(link["pd_Fn"]) \
            / link["pd_R_load"]
        i = p.q(i + draws["thermal"].to(p.real) * math.sqrt(S_T))
    if link["include_shot"]:
        S_N = (i_ph.mean() + link["i_dark"]) * 2 * Q_E * fs / 2
        i = p.q(i + draws["shot"].to(p.real) * torch.sqrt(S_N))
    H2 = torch.as_tensor(bessel_h2(link["lpf_order"], link["pd_BW"], fs, n),
                         device=dev).to(p.real)
    v = p.q(torch.fft.ifft(torch.fft.fft(i * link["pd_R_load"]) * H2).real)
    if link["adc_bits"] is not None:
        lo, hi = shortest_interval(v, 99.99)
        nq = 2 ** int(link["adc_bits"]) - 1
        v = p.q(torch.round((v - lo) / (hi - lo) * nq) / nq * (hi - lo)
                + lo)
    return v


# ---------------------------------------------------------------------------
# OOK receiver: eye metrology -> threshold -> slicer -> errors
# ---------------------------------------------------------------------------
def _resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """``scipy.signal.resample`` of a real signal to ``num`` samples
    (``num`` >= its length)."""
    n = x.numel()
    if num == n:
        return x
    X = torch.fft.fft(x)
    Y = torch.zeros(num, dtype=X.dtype, device=x.device)
    nyq = n // 2 + 1
    Y[:nyq] = X[:nyq]
    Y[num - (n - nyq):] = X[nyq:]
    if n % 2 == 0:
        Y[n // 2] *= 0.5
        Y[num - n // 2] = Y[n // 2]
    return torch.fft.ifft(Y).real * (num / n)


def _quantile(ys_sorted: torch.Tensor, q: float):
    n = ys_sorted.numel()
    pos = q * (n - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    return ys_sorted[lo] * (1 - (pos - lo)) + ys_sorted[hi] * (pos - lo)


def _half_interval_mid(vals: torch.Tensor):
    """Centre of the shortest interval holding half of ``vals``."""
    lo, hi = shortest_interval(vals, 50.0)
    return (lo + hi) / 2


def eye_levels(v: torch.Tensor, sps: int, nslots: int, sps_resamp,
               p: Precision) -> dict:
    """``mu0``, ``mu1``, ``s0``, ``s1``: the levels and spreads in the
    +-5 %-of-eye-width window at the optimum instant of the first
    ``nslots`` slots (blind: no bits used)."""
    n = v.numel()
    n -= n % (2 * sps)
    nslots = min(n // sps, int(nslots)) // 2 * 2
    y_in = torch.roll(v[:nslots * sps], -sps // 2 + 1)
    r = sps_resamp or sps
    y = p.q(_resample(y_in, nslots * r))
    t = torch.as_tensor(np.kron(np.ones(nslots // 2),
                                np.linspace(-1, 1 - 1 / r, 2 * r)),
                        device=v.device).to(p.real)

    # bi-level split: 2-means from the 10/90 % quantiles
    ys = torch.sort(y).values
    c0, c1 = _quantile(ys, 0.1), _quantile(ys, 0.9)
    for _ in range(32):
        lo = y <= (c0 + c1) / 2
        if 0 < int(lo.sum()) < y.numel() and bool(c0 != c1):
            c0, c1 = y[lo].mean(), y[~lo].mean()
    vm = (c0 + c1) / 2
    top, bot = y[y > vm], y[y < vm]
    state_1 = _half_interval_mid(top) if top.numel() > 2 else vm
    state_0 = _half_interval_mid(bot) if bot.numel() > 2 else vm
    d01 = state_1 - state_0
    v75, v25 = state_1 - 0.25 * d01, state_0 + 0.25 * d01
    mid = (state_0 + state_1) / 2

    # crossing instants: 2-means on the (t, y) points of the 25-75 % band
    band = (y > v25) & (y < v75)
    if int(band.sum()) >= 2:
        tb, yb = t[band], y[band]
        cen = torch.stack([torch.stack([t.min(), mid]),
                           torch.stack([t.max(), mid])])
        for _ in range(32):
            d0 = (tb - cen[0, 0]) ** 2 + (yb - cen[0, 1]) ** 2
            d1 = (tb - cen[1, 0]) ** 2 + (yb - cen[1, 1]) ** 2
            in1 = d1 < d0
            new = []
            for k, sel in ((0, ~in1), (1, in1)):
                new.append(torch.stack([tb[sel].mean(), yb[sel].mean()])
                           if bool(sel.any()) else cen[k])
            cen = torch.stack(new)
        left = int(torch.argmin(cen[:, 0]))

        def nearest(x):
            return t[torch.argmin(torch.abs(t - x))]
        t_left, t_right = nearest(cen[left, 0]), nearest(cen[1 - left, 0])
        t_c = nearest(cen[:, 0].mean())
    else:
        t_left, t_right, t_c = -0.5, 0.5, 0.0
    t_dist = t_right - t_left
    window = (t_c - 0.05 * t_dist < t) & (t < t_c + 0.05 * t_dist)
    y_center = y_in[torch.argmin(torch.abs(y_in - mid))]
    out = {}
    for name, sel in (("1", (y > y_center) & window),
                      ("0", (y < y_center) & window)):
        ysel = y[sel]
        mu = ysel.mean()
        out["mu" + name] = float(mu)
        out["s" + name] = float(torch.sqrt(((ysel - mu) ** 2).mean()))
    return out


def decide(levels: dict, slots: torch.Tensor, bits: torch.Tensor):
    """Threshold where the two levels' Gaussian tails meet (a 1000-point
    scan between the levels, in log space), then the error count."""
    mu0, mu1, s0, s1 = (levels[k] for k in ("mu0", "mu1", "s0", "s1"))
    r = torch.linspace(mu0, mu1, 1000, dtype=torch.float64,
                       device=slots.device)
    lq1 = torch.special.log_ndtr(-(mu1 - r) / s1)
    lq0 = torch.special.log_ndtr(-(r - mu0) / s0)
    rth = float(r[torch.argmin(torch.logaddexp(lq1, lq0))])
    n_err = int(((slots > rth) != (bits > 0)).sum())
    return rth, n_err


def run(cfg: dict, traffic: dict, bits, draws: dict, device,
        precision: str = "float64") -> dict:
    """One waveform through the whole link and the OOK receiver.
    ``bits``: the channel's bits (NumPy, 0/1).  Returns the voltage ``v``
    (a tensor on ``device``) and ``n_errors``, ``threshold``, ``mu0``,
    ``mu1``, ``s0``, ``s1``, ``n_steps`` (a list, one a fiber stage)."""
    p = Precision(precision)
    dev = torch.device(device)
    sps = cfg["params"]["sps"]
    b = torch.as_tensor(np.asarray(bits), device=dev)
    with torch.no_grad():
        A = transmit(cfg, b, draws, p, dev)
        A, steps = channel(cfg, A, draws, p, dev)
        v = receive(cfg, A, draws, p, dev)
        del A
        inst = cfg["link"]["sampler_instant"]
        slots = v[(sps // 2 if inst is None else inst)::sps]
        levels = eye_levels(v, sps, traffic["nslots"], traffic["sps_resamp"],
                            p)
        rth, n_err = decide(levels, slots, b)
    return dict(v=v, n_errors=n_err, threshold=rth, n_steps=steps, **levels)
