"""Device library of the staged API: the TX -> channel -> RX chain as one
call per device (port of ``opticomlib_tpu.devices``; reference
opticomlib/devices.py).

Every device keeps the JAX package's call signature, validation, messages
and physics; the waveforms are torch tensors.  Sources put their output on
``gv``'s device (the card unless ``gv(device="cpu")`` says otherwise); every other
device computes on the device of its input.  ``execution_time`` on each
result is the host wall time of the call, as in the reference's tic/toc;
on a card the work may still be running when the call returns.

Dtypes follow the JAX devices at every boundary: float64 / complex128 out
of ``DAC``, ``LASER``, ``MZM``, ``PD`` and ``LPF``, complex64 out of
``FIBER``.  ``DAC`` shapes its pulse in float32 (the ``fir_filter`` kernel,
as the TPU kernel computes it; see :func:`ops.pulses.fft_convolve_same`)
and returns float64.

Noise, as in the JAX package: with no ``key=`` and no ``gv(seed=...)`` the
devices draw from the legacy global ``np.random`` on the host, in the JAX
devices' call order and shapes, and move the draws to the signal's device
(so both packages see the same draws under one ``np.random.seed``); with a
key, from a ``torch.Generator`` on the signal's device
(:mod:`opticomlib_tpu_torch.rng`).

Noisy devices (``LASER``, ``EDFA``, ``PD``) also take ``noise=``: unit
normal draws by name (``phase``, ``rin``; ``ase``; ``thermal``, ``shot``)
in place of the generator's, as the fused link's ``noise=``; the same
draws as a key's generator would make give the same output.

Spans (:mod:`opticomlib_tpu_torch.utils.profiling`, off by default): each
call is one, under the fused link's layer names: ``tx`` (``DAC``,
``LASER``, ``PM``, ``MZM``; attribute ``device``), ``fiber`` (``FIBER``,
so ``DBP``), ``stage`` (``EDFA``, ``DM``, ``BPF``; ``kind``), ``rx.pd``
(``PD``, ``LPF``, ``ADC``; ``device``), ``rx.eye`` (``GET_EYE``) and
``rx.decide`` (``SAMPLER``; ``step``).

Device inventory (reference file:line): PRBS 63-182, DAC 185-350, LASER
353-510, PM 513-617, MZM 620-785, BPF 788-826, EDFA 829-942, DM 945-1035,
FIBER 1038-1206, DBP 1209-1283, LPF 1286-1375, PD 1378-1555, ADC 1558-1632,
GET_EYE 1635-1868, SAMPLER 1871-1891, FBG 1894-2322, the fiber animations
2326-2563.  ``FBG``'s coupled-mode integration is the ``fbg_rk4`` kernel
(:func:`opticomlib_tpu_torch.ops.kernels.fbg_rk4`); the animations import
Matplotlib when they are called.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Literal, Optional

import numpy as np
import scipy.signal as sg
import torch
from scipy.constants import c, e, k as kB, pi

from . import rng
from .eyediag import Eye
from .ops import eyeana, filters, kernels, noise as noise_ops, \
    prbs as prbs_ops, pulses, ssfm
from .params import current_device, gv
from .signals import (NULL, BinarySequence, ElectricalSignal, OpticalSignal,
                      RealNumber, _has_noise)
from .utils.analysis import db, idb, idbm, si, tic, toc
from .utils.analysis import dispersion as _dispersion_of, tau_g as _tau_g
from .utils.analysis import rcos as _rcos_spectrum
from .utils.profiling import span, spanned

__all__ = ["PRBS", "DAC", "LASER", "PM", "MZM", "BPF", "EDFA", "DM", "FIBER",
           "DBP", "LPF", "PD", "ADC", "GET_EYE", "SAMPLER", "FBG",
           "animated_fiber_propagation", "animated_fiber_propagation_with_phase"]


def _legacy_normal(sigma, shape, device) -> torch.Tensor:
    """``np.random.normal(0, sigma, shape)`` (float64, the legacy global
    stream) on ``device``."""
    return torch.as_tensor(np.random.normal(0, sigma, shape), device=device)


def _noise_source(key, noise, device):
    """The generator of a noisy device's draws (:func:`rng.resolve`), or
    ``None`` where ``noise`` injects them (the global stream is then not
    advanced) or where the legacy NumPy draws apply."""
    if noise is None:
        return rng.resolve(key, device)
    if key is not None:
        raise ValueError("pass `key` or `noise`, not both.")
    return None


def _injected(noise, name: str, device) -> torch.Tensor:
    """The unit draw ``noise[name]`` as float32 on ``device``."""
    if name not in noise:
        raise ValueError(f"`noise` has no {name!r} draw.")
    return noise_ops.as_draw(noise[name], device)


# ---------------------------------------------------------------------------
# PRBS (reference devices.py:63-182)
# ---------------------------------------------------------------------------
def PRBS(order: int, len: Optional[int] = None, seed: Optional[int] = None,
         return_seed: bool = False):
    """Pseudorandom binary sequence generator (orders 7/9/11/15/20/23/31),
    bit-exact with the reference LFSR.  Returns a host
    :class:`BinarySequence`, and the final register state when
    ``return_seed``."""
    tic()
    bits, state = prbs_ops.prbs(order, length=len, seed=seed)
    output = BinarySequence(bits)
    output.execution_time = toc()
    if return_seed:
        return output, state
    return output


# ---------------------------------------------------------------------------
# DAC (reference devices.py:185-350)
# ---------------------------------------------------------------------------
def _support(span: int, sps: int, half: float):
    """Grid indices ``[i0, i1)`` of ``np.linspace(-span/2, span/2,
    span*sps + 1)`` that cover ``|t| <= half`` slots, one point to spare."""
    centre = span * sps // 2
    reach = int(math.ceil(half * sps)) + 1
    return centre - reach, centre + reach + 1


@spanned("tx", device="DAC")
def DAC(input, pulse_shape: str = "nrz", coupling: str = "DC",
        Vpp: Optional[float] = 1.0, offset: Optional[float] = 0.0,
        h=None, BW: Optional[float] = None, **kwargs) -> ElectricalSignal:
    """Digital-to-analog converter: bits -> pulse-shaped electrical signal
    sampled at ``gv.fs`` (upsample x ``gv.sps`` + FIR shaping, ``mode=
    'same'``; reference devices.py:185-350), on ``gv``'s device.

    Parameters and validation are the JAX device's: ``pulse_shape`` in
    {'nrz', 'gaussian', 'rcos'} with ``T``, ``m``, ``c``, ``beta``,
    ``rcos_type`` in ``kwargs``; ``h`` custom taps; ``Vpp``, ``offset``,
    ``coupling`` ('DC' | 'AC') and ``BW`` (a Bessel low-pass, as ``LPF``).

    The pulse spans ``max(4, bits - 4)`` slots, as in the JAX device.  The
    nrz and chirp-free gaussian taps are evaluated only where they can be
    nonzero in float32 (the same values as the full grid's), and real taps
    that fit the ``fir_filter`` kernel shape in float32 through it; other
    taps (chirped gaussian, raised cosine, long custom ``h``) take the FFT
    convolution in float64 (:func:`ops.pulses.fft_convolve_same`).  The
    result is float64 (complex128 for complex taps).
    """
    tic()
    SHAPES = ["nrz", "gaussian", "rcos"]

    seq = BinarySequence(input)
    bits = seq.size
    sps = gv.sps
    data = torch.as_tensor(seq.to_numpy(np.float64), device=current_device())
    span = max(4, bits - 4)
    m_full = span * sps + 1

    if h is not None:
        x = pulses.upfir(data, np.asarray(h), up=sps)
    elif pulse_shape.lower() not in SHAPES:
        raise ValueError(
            f"The parameter `pulse_shape` must be one of the following values {SHAPES}")
    elif pulse_shape.lower() == "nrz":
        T = kwargs.get("T", 1)
        if not isinstance(T, (int, np.integer)) or isinstance(T, bool):
            raise TypeError("The parameter `T` must be an integer.")
        if T <= 0:
            raise ValueError("The parameter `T` must be greater than 0.")
        if T > 2 * sps:
            raise ValueError("The parameter `T` must be less than 2*sps.")
        win = _support(span, sps, T / 2)
        hp = pulses.nrz_pulse(span=span, sps=sps, T=T, window=win)
        x = pulses.upfir(data, hp, up=sps, m=m_full, start=max(win[0], 0))
    elif pulse_shape.lower() == "gaussian":
        c_ = kwargs.get("c", 0.0)
        m = kwargs.get("m", 1)
        T = kwargs.get("T", 1)
        if not isinstance(c_, RealNumber) or isinstance(c_, bool):
            raise TypeError("The parameter `c` must be a real number.")
        if not isinstance(m, (int, np.integer)) or isinstance(m, bool):
            raise TypeError("The parameter `m` must be an integer.")
        if not isinstance(T, (int, np.integer)) or isinstance(T, bool):
            raise TypeError("The parameter `T` must be an integer.")
        if m <= 0:
            raise ValueError("The parameter `m` must be greater than 0.")
        if T <= 0:
            raise ValueError("The parameter `T` must be greater than 0.")
        if T > 2 * sps:
            raise ValueError("The parameter `T` must be less than 2*sps.")
        if c_ == 0:
            # exp(-(a t)^(2m)) underflows float32 to 0 beyond
            # (a|t|)^(2m) = 150 ln 2 ~ 104; evaluate out to 110
            alpha = 2 * np.sqrt(np.log(2)) / T
            win = _support(span, sps, 110 ** (1 / (2 * m)) / alpha)
            hp = pulses.gauss_pulse(span=span, sps=sps, T=T, m=m, c=c_,
                                    window=win).real
            x = pulses.upfir(data, hp, up=sps, m=m_full,
                             start=max(win[0], 0))
        else:
            hp = pulses.gauss_pulse(span=span, sps=sps, T=T, m=m, c=c_)
            x = pulses.upfir(data, hp, up=sps)
    else:  # rcos
        beta = kwargs.get("beta", 0.25)
        rcos_type = kwargs.get("rcos_type", "normal")
        hp = pulses.rcos_pulse(beta=beta, span=span, sps=sps, shape=rcos_type)
        x = pulses.upfir(data, hp, up=sps)

    if Vpp is not None:
        if not isinstance(Vpp, RealNumber) or isinstance(Vpp, bool):
            raise TypeError("The parameter `Vpp` must be a scalar value.")
        if Vpp <= 0 or Vpp > 48:
            raise ValueError(
                "The parameter `Vpp` must be in the range (0, 48] Volts.")
        x = x * Vpp

    if offset is not None:
        if not isinstance(offset, RealNumber) or isinstance(offset, bool):
            raise TypeError("The parameter `offset` must be a scalar value.")
        if np.abs(offset) > 48:
            raise ValueError(
                "The parameter `offset` must be in the range [-48, 48] Volts.")
        x = x + offset

    if coupling.upper() == "AC":
        x = x - x.mean()
    elif coupling.upper() != "DC":
        raise ValueError("The parameter `coupling` must be either 'AC' or 'DC'.")

    output = ElectricalSignal(x)
    if BW is not None:
        output = LPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# LASER (reference devices.py:353-510)
# ---------------------------------------------------------------------------
@spanned("tx", device="LASER")
def LASER(P0, lw: Optional[float] = None, rin: Optional[float] = None,
          df: Optional[float] = None, key=None,
          noise: Optional[dict] = None) -> OpticalSignal:
    """CW laser complex envelope on ``gv``'s device: ``gv.N * gv.sps``
    samples of amplitude ``sqrt(idbm(P0))``, with Wiener phase noise
    (variance ``2*pi*lw*dt`` a step; a walk is drawn whenever ``lw`` is not
    None, even 0), Gaussian RIN (variance ``idb(rin)*fs``; raises if a draw
    crosses -1) and frequency offset ``df`` on ``gv.t`` (reference
    devices.py:353-510).  ``key``: an int seed or ``torch.Generator`` for
    keyed draws (:mod:`opticomlib_tpu_torch.rng`).  ``noise``: unit normal
    draws to use instead, ``{"phase": (n,), "rin": (n,)}`` (each needed
    only where it applies; ``phase`` only for ``lw > 0``): the same draws
    as a key's generator would make give the same output."""
    tic()
    dev = current_device()
    n = gv.nsamples
    out = torch.full((n,), float(np.sqrt(idbm(P0))), dtype=torch.float64,
                     device=dev)

    gen = _noise_source(key, noise, dev)

    if lw is not None and (noise is None or lw > 0):
        sigma = np.sqrt(2 * pi * lw * gv.dt)
        if noise is not None:
            phase_noise = noise_ops.wiener_phase(
                n, sigma, None, _injected(noise, "phase", dev))
        elif gen is not None:
            phase_noise = noise_ops.wiener_phase(n, sigma, gen)
        else:
            phase_noise = torch.as_tensor(
                np.cumsum(np.random.normal(0, sigma, n)), device=dev)
        if lw > 0:
            out = out * torch.exp(1j * phase_noise)

    if rin is not None:
        sigma = np.sqrt(idb(rin) * gv.fs)
        if noise is not None:
            rin_noise = noise_ops.gaussian(
                (n,), sigma, None, _injected(noise, "rin", dev))
        elif gen is not None:
            rin_noise = noise_ops.gaussian((n,), sigma, gen)
        else:
            rin_noise = _legacy_normal(sigma, n, dev)
        if rin_noise.min() < -1:
            raise ValueError(
                "Noise power is to high, try decrease RIN parameter.")
        out = out * torch.sqrt(1 + rin_noise)

    if df is not None:
        if np.abs(df) > gv.fs / 2:
            raise ValueError(
                "The laser frequency is out of the Nyquist range. "
                "Try increase the sampling frequency.")
        out = out * torch.exp(1j * torch.as_tensor(2 * pi * df * gv.t,
                                                   device=dev))

    output = OpticalSignal(out)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# PM (reference devices.py:513-617)
# ---------------------------------------------------------------------------
@spanned("tx", device="PM")
def PM(op_input: OpticalSignal, el_input, Vpi: float = 5.0) -> OpticalSignal:
    """Optical phase modulator: ``E * exp(j*pi*u(t)/Vpi)`` (reference
    devices.py:513-617); a scalar ``el_input`` is a static phase.  The
    optical noise track is rotated by the same phase."""
    tic()
    if not isinstance(op_input, OpticalSignal):
        raise TypeError("`op_input` must be of type 'optical_signal'.")
    if isinstance(el_input, RealNumber):
        # a complex128 factor, as the JAX device's NumPy scalar
        ph = torch.full((1,), complex(np.exp(1j * pi * float(el_input) / Vpi)),
                        dtype=torch.complex128, device=op_input.device)
    else:
        el = ElectricalSignal(el_input) if not isinstance(
            el_input, ElectricalSignal) else el_input
        u = el._total()
        u = (u.real if u.is_complex() else u).to(op_input.device)
        if u.ndim > 1:
            raise ValueError("`el_input` must be a scalar or 1D-array.")
        ph = torch.exp(1j * pi * u / Vpi)
    noi = op_input.noise * ph if _has_noise(op_input.noise) else NULL
    output = OpticalSignal(op_input.signal * ph, noi, n_pol=op_input.n_pol)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# MZM (reference devices.py:620-785)
# ---------------------------------------------------------------------------
def _zero_pol(x: torch.Tensor, kill: int) -> torch.Tensor:
    x = x.clone()
    x[kill] = 0
    return x


@spanned("tx", device="MZM")
def MZM(op_input: OpticalSignal, el_input, bias: float = 0.0,
        Vpi: float = 5.0, loss_dB: float = 0.0, ER_dB: float = 26.0,
        pol: str = "x", BW: Optional[float] = None) -> OpticalSignal:
    """Mach-Zehnder modulator, push-pull with finite extinction ratio:
    ``h(t) = sqrt(loss) * [cos(g) + j*(eta/2)*sin(g)]``,
    ``g = pi*(u + bias)/(2*Vpi)``, ``eta = 2*10**(-ER/20)`` (reference
    devices.py:620-785).  ``pol`` zeroes the other polarization of a 2-pol
    input; ``BW`` adds an optical Bessel band-pass (:func:`BPF`)."""
    tic()
    if not isinstance(op_input, OpticalSignal):
        raise TypeError("`op_input` must be of type 'optical_signal'.")
    el = ElectricalSignal(el_input) if not isinstance(
        el_input, ElectricalSignal) else el_input
    if el.ndim > 1:
        raise ValueError("`el_input` must be a scalar or 1D-array.")
    if el.size not in (1, op_input.size):
        raise ValueError(
            "`el_input` must be a scalar or an array of the same length as "
            "`op_input`.")
    if pol not in ("x", "y"):
        raise ValueError(
            "The parameter `pol` must be one of the following values ('x', 'y').")

    loss = idb(-loss_dB)
    eta = 2 * idb(-ER_dB) ** 0.5

    u = el._total()  # drive voltage = signal + noise
    u = (u.real if u.is_complex() else u).to(op_input.device)
    g_t = pi / 2 / Vpi * (u + bias)
    h_t = loss**0.5 * (torch.cos(g_t) + 1j * eta / 2 * torch.sin(g_t))

    # bilinear signal/noise product with the (noiseless) field transfer h(t)
    output = op_input * h_t
    output = OpticalSignal(output.signal, output.noise, n_pol=op_input.n_pol)

    if output.n_pol == 2:
        kill = 1 if pol == "x" else 0
        output.signal = _zero_pol(output.signal, kill)
        if _has_noise(output.noise):
            output.noise = _zero_pol(output.noise, kill)

    if BW is not None:
        output = BPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# BPF (reference devices.py:788-826)
# ---------------------------------------------------------------------------
def _filtered(x: torch.Tensor, H: np.ndarray) -> torch.Tensor:
    return filters.apply_freq_response(x, torch.as_tensor(H, device=x.device))


@spanned("stage", kind="bpf")
def BPF(input: OpticalSignal, BW: float, n: int = 4) -> OpticalSignal:
    """Optical band-pass filter (baseband low-pass equivalent): n-th order
    Bessel, zero-phase, as an FFT-domain multiply by the filtfilt-equivalent
    ``|H|^2`` (reference devices.py:788-826)."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type (optical_signal).")
    H2 = filters.bessel_filtfilt_response(
        n, float(BW / 2), float(gv.fs), int(input.signal.shape[-1])
    ).astype(np.float64)
    sig = _filtered(input.signal, H2)
    noi = _filtered(input.noise, H2) if _has_noise(input.noise) else NULL
    output = OpticalSignal(sig, noi, n_pol=input.n_pol)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# EDFA (reference devices.py:829-942)
# ---------------------------------------------------------------------------
@spanned("stage", kind="edfa")
def EDFA(input: OpticalSignal, G: float, NF: float,
         BW: Optional[float] = None, key=None,
         noise: Optional[dict] = None) -> OpticalSignal:
    """Flat-gain amplifier: field gain ``sqrt(G)`` plus ASE of power
    ``NF*h*f0*(G-1)*fs`` split over two polarizations x (re, im)
    (reference devices.py:829-942).  The output always carries 2
    polarizations, the ASE on its ``.noise`` track; ``BW`` adds an optical
    band-pass (:func:`BPF`); ``key`` as for :func:`LASER`; ``noise``: the
    unit normal draws to use instead, ``{"ase": (4, n)}`` (rows: x and y
    real, then x and y imaginary)."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")

    output = OpticalSignal(signal=input.signal, noise=input.noise,
                           n_pol=2) * np.sqrt(idb(G))
    output = OpticalSignal(output.signal, output.noise, n_pol=2)

    if input.n_pol == 1:
        output.signal = _zero_pol(output.signal, 1)
        if _has_noise(output.noise):
            output.noise = _zero_pol(output.noise, 1)

    P_ase = noise_ops.ase_power(G, NF, gv.f0, gv.fs)
    gen = _noise_source(key, noise, input.device)
    if noise is not None:
        ase = noise_ops.ase_draws(input.size, P_ase, None,
                                  _injected(noise, "ase", input.device))
    elif gen is not None:
        ase = noise_ops.ase_draws(input.size, P_ase, gen)
    else:
        d = torch.as_tensor(np.sqrt(P_ase / 4) * np.random.randn(4, input.size),
                            device=input.device)
        ase = torch.complex(d[:2], d[2:])

    noi = output.noise + ase if _has_noise(output.noise) else ase
    output = OpticalSignal(output.signal, noi, n_pol=2)

    if BW is not None:
        output = BPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# DM (reference devices.py:945-1035)
# ---------------------------------------------------------------------------
@spanned("stage", kind="dm")
def DM(input: OpticalSignal, D: float, retH: bool = False):
    """Pure dispersive medium: frequency-domain phase
    ``H = exp(j*w^2*D/2)`` with ``D`` in [ps^2] (reference
    devices.py:945-1035); ``retH`` also returns the fftshifted response
    (NumPy)."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")

    w = input.w() * 1e-12  # rad/ps
    H = np.exp(1j * w**2 * D / 2)

    sig = _filtered(input.signal, H)
    noi = _filtered(input.noise, H) if _has_noise(input.noise) else NULL
    output = OpticalSignal(sig, noi, n_pol=input.n_pol)
    output.execution_time = toc()
    if retH:
        return output, np.fft.fftshift(H)
    return output


# ---------------------------------------------------------------------------
# FIBER / DBP (reference devices.py:1038-1283)
# ---------------------------------------------------------------------------
def FIBER(input: OpticalSignal, length: float, alpha: float = 0.0,
          beta_2: float = 0.0, beta_3: float = 0.0, gamma: float = 0.0,
          phi_max: float = 0.01, h: Optional[float] = None,
          show_progress: bool = False, return_steps: bool = False,
          method: str = "reference", tol: float = 1e-5,
          mesh=None, shard_method: str = "pencil"):
    """Optical fiber: split-step Fourier NLSE (reference
    devices.py:1038-1206) on the input's device.

    ``method``: ``"reference"`` (symmetric steps, nonlinear operator frozen
    at the step start, ``phi_max``-adaptive or fixed ``h``), ``"o4"``
    (4th-order Yoshida, fixed ``h`` or self-tuning to ``tol``) or
    ``"local_error"`` (Sinkin step-doubling to ``tol``).  Units: ``length``
    km, ``alpha`` dB/km, ``beta_2`` ps^2/km, ``beta_3`` ps^3/km, ``gamma``
    1/W/km.  The kicks and spectral multiplies of every step are the
    ``nl_halfstep`` and ``cmul`` kernels (:mod:`opticomlib_tpu_torch.ops.
    ssfm`).  Its constants, the frequency axis and the dispersion phase,
    are computed on the input's device in float64, from NumPy's operations
    in NumPy's order (the host's numbers where ``beta_3 == 0``).

    ``mesh``: a mesh of ranks with a 'time' axis (and 'wdm';
    :func:`opticomlib_tpu_torch.parallel.make_link_mesh`): the sample axis
    is sharded across it and propagated by
    :func:`opticomlib_tpu_torch.parallel.fiber.ssfm_sharded`, adaptive
    (``h=None``, one all-reduce(max) a step) or fixed-step, with any of the
    three ``method`` schemes.  Every rank makes the same call on the same
    input.  ``shard_method``: ``'pencil'`` (exact distributed FFT),
    ``'overlap'`` (halo exchange, approximate) or ``'auto'``.  The output's
    payload stays on its ranks (a ``ShardedField``): the next
    ``FIBER(mesh=...)`` takes it as it is; any other device, signal
    operation or ``to_numpy()`` sees the whole field, gathered onto each
    rank's device (a collective every rank makes, as it makes this call).

    ``show_progress``: a tqdm bar over the reference scheme's steps
    (:class:`ops.ssfm.progress_bar`; ``tqdm`` is imported then).
    ``return_steps=True`` (reference scheme, no mesh): return the
    trajectory ``(z, A_z)`` instead, ``z`` the positions [km] as a float64
    NumPy array and ``A_z`` the field at each, complex64 frames stacked on
    the input's device, ``(steps + 1, n)`` or ``(steps + 1, 2, n)``
    (:func:`ops.ssfm.ssfm_propagate`).

    Returns a complex64 :class:`OpticalSignal` whose ``n_steps`` attribute
    is the number of steps taken (attempted, for the step-doubling
    schemes).

    The call is a ``fiber`` span (``kind="staged"``, ``method``, and on
    return ``steps`` and ``fused``: whether a step took the card's fused
    kernels), the host's constants of the propagation a ``fiber.prepare``
    span inside it (:func:`utils.profiling.span`).
    """
    with span("fiber", kind="staged", method=method) as sp:
        fused = ssfm.fused_steps()
        output = _fiber(input, length, alpha, beta_2, beta_3, gamma, phi_max,
                        h, show_progress, return_steps, method, tol, mesh,
                        shard_method)
        if isinstance(output, OpticalSignal):
            sp.set(steps=output.n_steps, fused=ssfm.fused_steps() > fused)
        return output


def _fiber(input, length, alpha, beta_2, beta_3, gamma, phi_max, h,
           show_progress, return_steps, method, tol, mesh, shard_method):
    """:func:`FIBER`'s work."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")
    if method not in ("reference", "o4", "local_error"):
        raise ValueError(
            "`method` must be 'reference', 'o4' or 'local_error'.")
    if mesh is not None:
        if return_steps:
            toc()
            raise ValueError("mesh= does not support return_steps")
        from .parallel.fiber import ShardedField, ssfm_sharded

        # a ShardedField payload (the previous FIBER(mesh=) output) goes
        # straight back to the sharded solver, each block where it lies
        if (isinstance(input.signal, ShardedField)
                and not _has_noise(input.noise)):
            A = input.signal
        else:
            A = input._total()
        wdm_axis = ("wdm" if "wdm" in mesh.axis_names and A.ndim == 2
                    and A.shape[0] % mesh.size("wdm") == 0 else None)
        out = ssfm_sharded(
            A, mesh, fs=gv.fs, length=float(length), alpha=float(alpha),
            beta_2=float(beta_2), beta_3=float(beta_3), gamma=float(gamma),
            h=None if h is None else float(h), phi_max=float(phi_max),
            method=shard_method, wdm_axis=wdm_axis, scheme=method,
            tol=float(tol))
        output = OpticalSignal(out, n_pol=input.n_pol)
        output.n_steps = out.n_steps
        output.execution_time = toc()
        return output
    if return_steps and method != "reference":
        toc()
        raise ValueError("return_steps is only available with "
                         "method='reference'.")

    A = input._total()
    w = _w_on(A)
    common = dict(alpha=float(alpha), beta_2=float(beta_2),
                  beta_3=float(beta_3), gamma=float(gamma))
    if method == "o4":
        if h is None:
            A, steps = ssfm.ssfm_o4_auto(A, w, float(length), tol=float(tol),
                                         **common)
        else:
            A, steps = ssfm.ssfm_scan_o4(A, w, float(length), h=float(h),
                                         **common)
    elif method == "local_error":
        A, steps = ssfm.ssfm_local_error(
            A, w, float(length), tol=float(tol),
            h0=None if h is None else float(h), **common)
    else:
        progress = show_progress and not return_steps
        with ssfm.progress_bar() if progress else contextlib.nullcontext():
            result = ssfm.ssfm_propagate(
                A, w, float(length), phi_max=float(phi_max),
                h=None if h is None else float(h), return_steps=return_steps,
                **common)
        if return_steps:
            toc()  # balance the timer stack (no result object to annotate)
            return result  # (z, A_z)
        A, steps = result

    output = OpticalSignal(A, n_pol=input.n_pol)
    output.n_steps = int(steps)
    output.execution_time = toc()
    return output


def _w_on(A: torch.Tensor) -> torch.Tensor:
    """``OpticalSignal.w()`` of a field ``A``, ``2*pi*fftfreq(n, gv.dt)`` in
    float64, computed on ``A``'s device: NumPy's operations in its order,
    so the same numbers."""
    w = torch.fft.fftfreq(A.shape[-1], gv.dt, dtype=torch.float64,
                          device=A.device)
    return w * 2 * np.pi


def DBP(input: OpticalSignal, length: float, alpha: float = 0.0,
        beta_2: float = 0.0, beta_3: float = 0.0, gamma: float = 0.0,
        phi_max: float = 0.01, h: Optional[float] = None,
        show_progress: bool = False, return_steps: bool = False,
        method: str = "reference", tol: float = 1e-5):
    """Digital back-propagation: :func:`FIBER` with all operator signs
    inverted (alpha, beta and gamma; reference devices.py:1209-1283)."""
    return FIBER(input, length=length, alpha=-alpha, beta_2=-beta_2,
                 beta_3=-beta_3, gamma=-gamma, phi_max=phi_max, h=h,
                 show_progress=show_progress, return_steps=return_steps,
                 method=method, tol=tol)


# ---------------------------------------------------------------------------
# LPF (reference devices.py:1286-1375)
# ---------------------------------------------------------------------------
@spanned("rx.pd", device="LPF")
def LPF(input, BW: float, n: int = 4, fs: Optional[float] = None,
        retH: bool = False):
    """Electrical low-pass: n-th order Bessel, zero-phase, real output
    (reference devices.py:1286-1375); signal and noise tracks are filtered
    alike.  ``fs`` defaults to ``gv.fs``; ``retH`` also returns the one-pass
    response H(w) on the fftshifted grid (NumPy)."""
    tic()
    if not isinstance(input, ElectricalSignal):
        input = ElectricalSignal(input)
    if input.ndim != 1:
        raise ValueError("`input` must be a 1D-array.")
    if not fs:
        fs = gv.fs

    def lpf(x):
        y = filters.bessel_lpf(x, float(BW), float(fs), n)
        return y.real if y.is_complex() else y

    noi = lpf(input.noise) if _has_noise(input.noise) else NULL
    output = ElectricalSignal(lpf(input.signal), noi)

    if retH:
        H = filters.bessel_sos_response(n, float(BW), float(fs), input.size)
        output.execution_time = toc()
        return output, np.fft.fftshift(H)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# PD (reference devices.py:1378-1555)
# ---------------------------------------------------------------------------
@spanned("rx.pd", device="PD")
def PD(input: OpticalSignal, BW: float, r: float = 1.0, T: float = 300.0,
       R_load: float = 50.0, include_noise: str = "all",
       i_dark: float = 10e-9, Fn: float = 0, key=None,
       noise: Optional[dict] = None) -> ElectricalSignal:
    """PIN photodetector (reference devices.py:1378-1555): ``i = r*|E|^2``
    summed over polarizations, the signal-ASE and ASE-ASE beats falling out
    of the signal/noise algebra; thermal ``4*kB*T*Fn*Df/R_L`` and shot
    ``2*e*(i_mean + i_dark)*Df`` noise drawn as Gaussians, thermal first;
    the voltage ``i*R_load`` low-pass filtered to ``BW``.  ``include_noise``
    picks the terms ('ase-only', ..., 'all', 'none'); ``key`` as for
    :func:`LASER`; ``noise``: the unit normal draws to use instead,
    ``{"thermal": (n,), "shot": (n,)}`` (each needed only where its term
    is included)."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")
    if not isinstance(r, RealNumber) or isinstance(r, bool):
        raise TypeError("`r` must be a scalar value.")
    if r <= 0 or r > 1:
        raise ValueError("`r` must be in the range (0,1]")
    if not isinstance(T, RealNumber) or isinstance(T, bool):
        raise TypeError("`T` must be a scalar value.")
    if T < 0:
        raise ValueError("`T` must be a positive value.")
    if not isinstance(R_load, RealNumber) or isinstance(R_load, bool):
        raise TypeError("`R_load` must be a scalar value.")
    if R_load < 0:
        raise ValueError("`R_load` must be a positive value.")
    if not isinstance(include_noise, str):
        raise TypeError("`include_noise` must be a string.")

    i_ph = (input * input.conj()).real * r
    if input.n_pol == 2:
        i_ph = i_ph.sum(axis=0)

    include_noise = include_noise.lower()
    valid = {"ase-only", "thermal-only", "shot-only", "ase-thermal",
             "ase-shot", "thermal-shot", "all", "none"}
    if include_noise not in valid:
        raise ValueError(
            "The argument `include_noise` must be one of the following: "
            "'ase-only','thermal-only','shot-only','ase-thermal','ase-shot',"
            "'thermal-shot','all', 'none'.")

    dev = input.device
    gen = _noise_source(key, noise, dev)

    i_T = i_N = None
    if "thermal" in include_noise or include_noise == "all":
        S_T = 4 * kB * T * gv.fs / 2 * idb(Fn) / R_load
        if noise is not None:
            i_T = noise_ops.gaussian((input.size,), S_T**0.5, None,
                                     _injected(noise, "thermal", dev))
        elif gen is not None:
            i_T = noise_ops.gaussian((input.size,), S_T**0.5, gen)
        else:
            i_T = _legacy_normal(S_T**0.5, input.size, dev)
    if "shot" in include_noise or include_noise == "all":
        mean_i = float(i_ph._total().to(torch.float64).mean())
        S_N = 2 * e * (mean_i + i_dark) * gv.fs / 2
        if noise is not None:
            i_N = noise_ops.gaussian((input.size,), S_N**0.5, None,
                                     _injected(noise, "shot", dev))
        elif gen is not None:
            i_N = noise_ops.gaussian((input.size,), S_N**0.5, gen)
        else:
            i_N = _legacy_normal(S_N**0.5, input.size, dev)

    ase = i_ph.noise if _has_noise(i_ph.noise) else 0.0

    if include_noise == "ase-only":
        i_noise = ase + i_dark
    elif include_noise == "thermal-only":
        i_noise = i_T + i_dark
    elif include_noise == "shot-only":
        i_noise = i_N + i_dark
    elif include_noise == "ase-shot":
        i_noise = ase + i_N + i_dark
    elif include_noise == "ase-thermal":
        i_noise = ase + i_T + i_dark
    elif include_noise == "thermal-shot":
        i_noise = i_T + i_N + i_dark
    elif include_noise == "all":
        i_noise = ase + i_N + i_T + i_dark
    else:  # none
        i_noise = None

    if i_noise is None:
        noi = NULL
    else:
        i_noise = torch.as_tensor(i_noise, device=dev).to(torch.float64)
        noi = (i_noise * R_load).expand(input.size).clone()

    output = ElectricalSignal(i_ph.signal * R_load, noi)
    output = LPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# ADC (reference devices.py:1558-1632)
# ---------------------------------------------------------------------------
def _shortest_int(x: torch.Tensor, percent: float):
    """``utils.analysis.shortest_int`` on a real tensor, on its device."""
    x = torch.sort(x.reshape(-1)).values
    lag = int(x.numel() * percent / 100)
    if lag < 1:
        raise ValueError(
            f"Computed lag ({lag}) must be at least 1; percent ({percent}%) "
            f"too small for length {x.numel()}.")
    diff = x[lag:] - x[:-lag]
    i = torch.nonzero(torch.abs(diff - diff.min()) < 1e-10).reshape(-1)
    i = int(i.to(torch.float64).mean()) if i.numel() > 1 else int(i[0])
    return x[i], x[i + lag]


@spanned("rx.pd", device="ADC")
def ADC(input, fs: Optional[float] = None, n: int = 8,
        otype: str = "v") -> ElectricalSignal:
    """Analog-to-digital converter (reference devices.py:1558-1632):
    optional FFT resampling to ``fs``, then ``n``-bit uniform quantization
    of the signal track's real part over its shortest interval holding
    99.99 % of the samples (half-to-even codes, no clip: samples outside
    extrapolate).  ``otype``: 'v' volts or 'n' integer codes.  Plain torch
    in float64, as the JAX device quantizes on the host (not the
    ``adc_quantize`` kernel, which is the fused link's)."""
    tic()
    if not isinstance(input, ElectricalSignal):
        input = ElectricalSignal(input)
    signal = input.signal

    if fs is not None:
        signal = pulses.resample_fft(signal, int(input.size * fs / input.fs))

    re = (signal.real if signal.is_complex() else signal).to(torch.float64)
    V_min, V_max = _shortest_int(re, 99.99)
    dig = torch.round((re - V_min) / (V_max - V_min) * (2**n - 1)).to(
        torch.int64)
    if otype == "v":
        # a tensor divisor: torch on CUDA turns division by a Python scalar
        # into a multiplication by its reciprocal, which rounds differently
        nq = torch.tensor(2**n - 1, dtype=torch.float64, device=re.device)
        dig = dig.to(torch.float64) / nq * (V_max - V_min) + V_min
    elif otype != "n":
        raise ValueError("`otype` must be 'v' or 'n'.")

    output = ElectricalSignal(dig)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# GET_EYE (reference devices.py:1635-1868)
# ---------------------------------------------------------------------------
_EYE_NAN_TO_NONE = ("threshold", "y_left", "y_right")


def _eye_on_host(metrics: dict) -> dict:
    """The tensor engine's result as the host engine gives it: the scalars
    as Python numbers, NaN as None where the host engine says None, the
    traces as NumPy arrays.  One read-back for all: from a card every
    tensor is copied into page-locked host memory, which the traces'
    arrays then hold (PyTorch's caching host allocator takes it back when
    they go), and the stream is waited on once."""
    scalars = [k for k, v in metrics.items()
               if isinstance(v, torch.Tensor) and v.ndim == 0]
    arrays = [k for k, v in metrics.items()
              if isinstance(v, torch.Tensor) and v.ndim > 0]
    values, *host = _on_host(
        [torch.stack([metrics[k].to(torch.float64) for k in scalars])]
        + [metrics[k] for k in arrays])
    for k, v in zip(scalars, values.tolist()):
        metrics[k] = int(v) if k == "i" else v
    for k, v in zip(arrays, host):
        metrics[k] = v.numpy()
    for k in _EYE_NAN_TO_NONE:
        if metrics.get(k) is not None and np.isnan(metrics[k]):
            metrics[k] = None
    return metrics


def _on_host(tensors: list) -> list:
    """Host copies of ``tensors`` (of one device): from a card, queued into
    page-locked memory and waited on once."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.cpu() for t in tensors]
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.append(h.copy_(t, non_blocking=True))
    torch.cuda.current_stream(dev).synchronize()
    return out


def GET_EYE(input, nslots: int = 4096,
            sps_resamp: Optional[int] = None,
            engine: Literal["auto", "host", "device"] = "auto") -> Eye:
    """Blind eye-diagram metrology (reference devices.py:1635-1868).

    ``engine``: ``"host"`` runs the JAX package's NumPy pipeline
    (:func:`ops.eyeana.eye_metrics_host`) on a host copy in float64;
    ``"auto"`` and ``"device"`` run the tensor pipeline of
    :func:`ops.eyeana.eye_metrics`, the port of the JAX package's device
    twin (``eye_metrics_jax``), on the signal's device; on a card, from a
    shape's third call, as one CUDA graph replay of the same kernels
    (:func:`ops.eyeana.eye_scalars` with its traces), so the same bits.
    Level means and spreads (``mu0/mu1/s0/s1``), crossing times
    (``t_left/t_right/t_opt``), ``er``, ``eye_h``, the KDE ``threshold``
    and the sampling instant ``i`` come back as Python numbers, the
    rendering traces as NumPy arrays.  The call is an ``rx.eye`` span
    (``graph``: ``"eager"``, ``"capture"`` or ``"replay"``, or ``"host"``
    for the host engine)."""
    with span("rx.eye") as sp:
        tic()
        if isinstance(input, np.ndarray) and input.ndim > 2:
            raise ValueError("The input must be a 1D or 2D array.")
        if not isinstance(input, ElectricalSignal):
            input = ElectricalSignal(input)

        samples = input._total()
        samples = samples.real if samples.is_complex() else samples
        if samples.ndim == 2:
            samples = samples.sum(dim=0)
        if engine == "host":
            metrics = eyeana.eye_metrics_host(samples, sps=input.sps,
                                              nslots=nslots,
                                              sps_resamp=sps_resamp)
            sp.set(graph="host")
        else:
            e = eyeana.eye_scalars(samples, sps=input.sps, nslots=nslots,
                                   sps_resamp=sps_resamp, traces=True)
            metrics = _eye_on_host(e.m)
            sp.set(graph=e.how)
        metrics["dt"] = input.dt
        metrics["execution_time"] = toc()
        return Eye(metrics)


# ---------------------------------------------------------------------------
# SAMPLER (reference devices.py:1871-1891)
# ---------------------------------------------------------------------------
@spanned("rx.decide", step="sampler")
def SAMPLER(input: ElectricalSignal, instant: int) -> ElectricalSignal:
    """Downsample to 1 sample/slot: ``input[instant::gv.sps]`` (reference
    devices.py:1871-1891)."""
    tic()
    output = ElectricalSignal(input)[instant::gv.sps]
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# FBG (reference devices.py:1894-2322)
# ---------------------------------------------------------------------------
def _fbg_apodization(apodization):
    if apodization == "rcos":
        return lambda z: _rcos_spectrum(z, alpha=1, T=2)
    if apodization == "gaussian":
        return lambda z: np.exp(-4 * np.log(2) * (3 * z) ** 2)
    if apodization == "parabolic":
        return lambda z: 1 - (2 * z) ** 2
    if apodization == "uniform":
        return None
    if callable(apodization):
        return apodization
    if isinstance(apodization, str):
        warnings.warn(
            "Apodization function not recognized. Using uniform apodization.")
        return None
    raise ValueError("Apodization must be a string or a function.")


def _fbg_resolve_geometry(neff, v, landa_D, fc, kL, L, N, dneff, vdneff):
    """Parameter-combination resolver (reference devices.py:2099-2176)."""
    if fc:
        if dneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `fc` and `dneff` are specified, `L`, `kL` or `N` "
                    "must be specified.")
            landa_D = 1 / (1 + dneff / neff) * c / fc
            vdneff = dneff * v
            if kL:
                L = kL / (pi * dneff * v / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        elif vdneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `fc` and `vdneff` are specified, `L`, `kL` or `N` "
                    "must be specified.")
            landa_D = c / fc
            dneff = 0
            if kL:
                L = kL / (pi * vdneff / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        else:
            raise ValueError(
                "If `fc` is specified, `dneff` or `vdneff` must be specified.")
    elif landa_D:
        if dneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `landa_D` and `dneff` are specified, `L`, `kL` or "
                    "`N` must be specified.")
            vdneff = dneff * v
            if kL:
                L = kL / (pi * vdneff / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        elif vdneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `landa_D` and `vdneff` are specified, `L`, `kL` or "
                    "`N` must be specified.")
            dneff = 0
            if kL:
                L = kL / (pi * vdneff / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        elif kL:
            if not (L or N):
                raise ValueError(
                    "If `landa_D` and `kL` are specified, `L` or `N` must "
                    "be specified.")
            if N:
                L = N * landa_D / (2 * neff)
            vdneff = kL * landa_D / (pi * L)
            dneff = vdneff / v
        else:
            raise ValueError(
                "If `landa_D` is specified, `dneff`, 'vdneff' or `kL` must "
                "be specified.")
    else:
        raise ValueError("Either `fc` or `landa_D` must be specified.")
    return landa_D, L, dneff, vdneff


def _fbg_steps(delta: np.ndarray, s: np.ndarray, k: np.ndarray, F) -> int:
    """RK4 steps that resolve the fastest phase rotation of the coupled-mode
    equations: ``|shat| <= |delta| + |s| + |F|/2`` a unit of z, at least
    four steps a radian, 512 to 200,000 (the JAX device's rule)."""
    rate = float(np.max(np.abs(delta) + np.abs(s)) + abs(F) / 2
                 + np.max(np.abs(k)))
    return int(min(max(512, 4 * rate), 200_000))


def _fbg_grid(apo_func, n_steps: int, device) -> tuple:
    """The RK4 step grid of :func:`ops.kernels.fbg_rk4` on ``device``:
    ``(p0, p1, p2, zs)``, the apodization at the three stage positions and
    the step starts ``1/2 - j/n_steps``, float32 as the JAX device makes
    them (ones for a uniform grating)."""
    dz = -1.0 / n_steps
    zs_host = 0.5 + dz * np.arange(n_steps)
    if apo_func is not None:
        p = [np.asarray(apo_func(zs_host + off), dtype=np.float32)
             for off in (0.0, dz / 2, dz)]
    else:
        p = [np.ones(n_steps, dtype=np.float32)] * 3
    zs = np.asarray(zs_host, dtype=np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (*p, zs))


def _fbg_rk4_inputs(lam: np.ndarray, neff, lam_D, L, dneff, vdneff,
                    apodization, F, device) -> tuple:
    """The arguments of :func:`ops.kernels.fbg_rk4` for a grating at the
    wavelengths ``lam`` [m]: the detuning ``delta``, DC self-coupling ``s``
    and AC coupling ``k`` of each bin (float64 on the host, then float32 on
    ``device``), the chirp ``F``, the step grid of :func:`_fbg_grid` and
    the step count of :func:`_fbg_steps`."""
    delta = 2 * pi * neff * (1 / lam - 1 / lam_D) * L
    s = 2 * pi * dneff / lam * L
    k = pi * vdneff / lam * L
    n_steps = _fbg_steps(delta, s, k, F)
    coeff = (torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
             for a in (delta, s, k))
    return (*coeff, F, *_fbg_grid(_fbg_apodization(apodization), n_steps,
                                  device), n_steps)


def _peak_widths(y: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    """``scipy.signal.peak_widths(y, peaks)[0]``, equal to it, without its
    cost of O(peaks x n).

    scipy finds each peak's prominence by scanning out to the nearest
    higher sample on either side, to the end of the array if there is none.
    At 2^24 bins the float32 round-off of the RK4 makes millions of local
    maxima on the falling tails of |H|, and each scans to the end.  Here
    every prominence is scipy's own, from windows of ``2w + 1`` samples
    (``peak_prominences(wlen=)``) that double until it is settled: a side
    whose window holds a higher sample (or reaches the end) has its true
    minimum, and the prominence is the peak less the larger of the two
    minima, so once one side is settled and the other side's window already
    holds a sample as low, the rest of that side cannot change it.  The
    widths at half prominence then stop at the first sample below that
    height on either side, within the bases, as scipy's do."""
    y = np.asarray(y, dtype=np.float64)
    n = y.size
    prom = np.empty(peaks.size)
    todo = np.arange(peaks.size)
    w = 16
    while todo.size:
        p = peaks[todo]
        pw, lb, rb = sg.peak_prominences(y, p, wlen=2 * w + 1)
        left, right = p - w <= 0, p + w >= n - 1
        if w < n:
            win = np.lib.stride_tricks.sliding_window_view(y, w)
            i = ~left
            left[i] = win[p[i] - w].max(axis=1) > y[p[i]]
            i = ~right
            right[i] = win[p[i] + 1].max(axis=1) > y[p[i]]
        lmin, rmin = y[lb], y[rb]
        done = ((left & right) | (left & (rmin <= lmin))
                | (right & (lmin <= rmin)))
        prom[todo[done]] = pw[done]
        todo = todo[~done]
        w *= 2
    bases = (np.zeros(peaks.size, np.intp), np.full(peaks.size, n - 1, np.intp))
    return sg.peak_widths(y, peaks, prominence_data=(prom, *bases))[0]


def FBG(input: OpticalSignal, neff: float = 1.45, v: float = 1.0,
        landa_D: Optional[float] = None, fc: Optional[float] = None,
        kL: Optional[float] = None, L: Optional[float] = None,
        N: Optional[int] = None, dneff: Optional[float] = None,
        vdneff: Optional[float] = None,
        apodization="uniform", F: float = 0,
        print_params: bool = True, filtfilt: bool = True,
        retH: bool = False):
    """Fiber Bragg grating reflectivity via coupled-mode theory (reference
    devices.py:1894-2322; the JAX device's parameters, rules, printed
    design block and messages).

    The grid (wavelengths, detuning ``delta``, self- and cross-coupling
    ``s``, ``k``) is float64 on the host; the z-integration, fixed-step RK4
    from ``z = 1/2`` to ``-1/2`` with the step count chosen from the
    fastest phase rotation (:func:`_fbg_steps`), runs on the input's device
    through the ``fbg_rk4`` kernel (its plain version on the CPU).
    ``H = S/R``, the bandwidth (``find_peaks`` and the widest peak's width,
    :func:`_peak_widths`: scipy's ``peak_widths`` in O(n log n)), the
    dispersion at the centre and the group-delay removal (``filtfilt``)
    are host NumPy, and the input is filtered by ``H`` on its device.

    Parameters: ``neff``, ``v`` (effective index, fringe visibility);
    ``landa_D`` or ``fc`` (design wavelength [m] or centre frequency [Hz]);
    one of ``kL``, ``dneff``, ``vdneff`` (coupling); ``L`` or ``N`` (length
    [m] or periods); ``apodization`` ('uniform' | 'rcos' | 'gaussian' |
    'parabolic' or ``f(z)`` on z in [-1/2, 1/2]); ``F`` (linear chirp);
    ``print_params``; ``filtfilt``; ``retH``: also return the fftshifted
    response H (NumPy), as ``DM(retH=True)`` does.
    """
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")

    landa_D, L, dneff, vdneff = _fbg_resolve_geometry(
        neff, v, landa_D, fc, kL, L, N, dneff, vdneff)

    lam_D = landa_D
    Lam = lam_D / (2 * neff)                    # grating period
    lam_c = (1 + dneff / neff) * lam_D          # center wavelength
    fc = c / lam_c

    lam = 2 * pi * c / (input.w(shift=True) + 2 * pi * gv.f0)
    dlam = lam[1] - lam[0]

    N = int(L / Lam)
    kL = pi / lam_D * vdneff * L

    R, S = kernels.fbg_rk4(*_fbg_rk4_inputs(
        lam, neff, lam_D, L, dneff, vdneff, apodization, F, input.device))

    H = S.cpu().numpy() / R.cpu().numpy()
    y = np.abs(H)
    ic = int(np.argmin(np.abs(lam - c / fc)))

    peaks, _ = sg.find_peaks(y)
    H_max = y[ic]

    if (y > 0.5).all():
        warnings.warn(
            "Bandwidth of the grating is too large for current sampling "
            "rate (`fs`). Consider increasing `fs`.")
        bw_str = f' - Δf = >{si(gv.fs, "Hz")} (Δλ = >{si(gv.fs * c / fc**2, "m")})'
    elif len(peaks):
        BW_lam = _peak_widths(y, peaks).max() * dlam
        BW_f = fc**2 * BW_lam / c
        bw_str = f' - Δf = {si(BW_f, "Hz")} (Δλ = {si(BW_lam, "m")})'
    else:
        warnings.warn("No peaks found in the reflectivity of the grating.")
        bw_str = " - Δf = -- GHz (Δλ = -- nm)"

    D = _dispersion_of(H, gv.fs, fc)[ic]

    if print_params:
        print("\n*** Fiber Bragg Grating Features ***")
        print(f' - Λ = {si(Lam, "m")}')
        print(f" - N = {N}")
        print(f' - L = {si(L, "m")}')
        print(f' - λc = {si(c / fc, "m", 4)}')
        print(bw_str)
        print(f" - ρo = {y.max():.2f}")
        print(f" - loss = {-db(max(H_max, 1e-30)**2):.1f} dB")
        print(f" - vδneff = {vdneff:.1e}")
        print(f" - kL = {kL:.1f}")
        print(f" - D(λc) = {D:.1f} ps/nm")
        if F:
            print(f" - F = {F:.1f}")
            print(f' - ΔΛ = {si(np.abs(Lam * F / (2 * pi * N)), "m")}')
        print("************************************\n")

    if filtfilt:  # remove the bulk group delay so pulses stay centered
        H = H * np.exp(-1j * input.w(shift=True) * _tau_g(H, gv.fs)[ic] * 1e-12)

    H_fft = np.fft.ifftshift(H)
    sig = _filtered(input.signal, H_fft)
    noi = _filtered(input.noise, H_fft) if _has_noise(input.noise) else NULL
    output = OpticalSignal(sig, noi, n_pol=input.n_pol)

    output.execution_time = toc()
    if retH:
        return output, H
    return output


# ---------------------------------------------------------------------------
# fiber propagation animation (reference devices.py:2326-2563)
# ---------------------------------------------------------------------------
def _trajectory_on_host(input, **fiber):
    """``FIBER(..., return_steps=True)`` with the frames brought to the
    host: ``(z, A_z)`` as NumPy arrays, a 2-pol trajectory summed over the
    polarizations."""
    z, A_z = FIBER(input, return_steps=True, **fiber)
    A_z = A_z.cpu().numpy()
    return z, (A_z if A_z.ndim == 2 else A_z.sum(axis=1))


def animated_fiber_propagation(input: OpticalSignal, M: int, length: float,
                               alpha: float = 0.0, beta_2: float = 0.0,
                               beta_3: float = 0.0, gamma: float = 0.0,
                               phi_max: float = 0.01,
                               h: Optional[float] = None,
                               interval: int = 100,
                               show: bool = True):
    """Matplotlib animation of |A(z, t)| along the fiber, built from the
    trajectory of ``FIBER(return_steps=True)``."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    z, A_z = _trajectory_on_host(input, length=length, alpha=alpha,
                                 beta_2=beta_2, beta_3=beta_3, gamma=gamma,
                                 phi_max=phi_max, h=h)
    mag = np.abs(A_z)
    t = gv.t * 1e9

    fig, ax = plt.subplots()
    (line,) = ax.plot(t, mag[0])
    ax.set_xlabel("t [ns]")
    ax.set_ylabel("|A(z,t)|")
    ax.set_ylim(0, float(mag.max()) * 1.1)

    def update(i):
        line.set_ydata(mag[i])
        ax.set_title(f"z = {z[i]:.2f} km")
        return (line,)

    anim = FuncAnimation(fig, update, frames=len(z), interval=interval,
                         blit=False)
    if show:
        plt.show()
    return anim


def animated_fiber_propagation_with_phase(
        input: OpticalSignal, length: float, alpha: float = 0.0,
        beta_2: float = 0.0, beta_3: float = 0.0, gamma: float = 0.0,
        phi_max: float = 0.05, h: Optional[float] = None,
        interval: int = 100, show: bool = True):
    """Animation of |A(z,t)|, instantaneous phase and chirp along the fiber
    (reference devices.py:2461-2563).  The loss is compensated out of the
    displayed field (``A * exp(alpha*z/2)``) so amplitude changes shown are
    purely dispersive/nonlinear, and the phase is unwrapped and referenced
    to the pulse center, as in the reference."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    z, A_z = _trajectory_on_host(input, length=length, alpha=alpha,
                                 beta_2=beta_2, beta_3=beta_3, gamma=gamma,
                                 phi_max=phi_max, h=h)
    alpha_lin = alpha / 4.342944819032518
    A_z = A_z * np.exp(alpha_lin * z[:, None] / 2)  # undo loss for display

    ic = int(np.argmax(np.abs(A_z[0])))
    mag = np.abs(A_z)
    ph = np.unwrap(np.angle(A_z), axis=-1)
    ph = ph - ph[:, ic:ic + 1] + np.angle(A_z)[:, ic:ic + 1]
    # instantaneous frequency deviation (chirp) [rad/ps]
    om = -np.gradient(ph, gv.dt * 1e12, axis=-1)

    t = gv.t * gv.R
    t = t - t.max() / 2

    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, sharex=True, figsize=(8, 8))
    (l1,) = ax1.plot(t, mag[0])
    (l2,) = ax2.plot(t, ph[0])
    (l3,) = ax3.plot(t, om[0])
    ax1.set_ylabel("|A(z,t)|")
    ax2.set_ylabel("phase [rad]")
    ax3.set_ylabel("chirp [rad/ps]")
    ax3.set_xlabel("t/T")
    ax1.set_ylim(0, float(mag.max()) * 1.1)
    ax2.set_ylim(float(ph.min()), float(ph.max()))
    ax3.set_ylim(float(np.percentile(om, 1)), float(np.percentile(om, 99)))

    def update(i):
        l1.set_ydata(mag[i])
        l2.set_ydata(ph[i])
        l3.set_ydata(om[i])
        ax1.set_title(f"z = {z[i]:.2f} km")
        return l1, l2, l3

    anim = FuncAnimation(fig, update, frames=len(z), interval=interval,
                         blit=False)
    if show:
        plt.show()
    return anim
