"""The fused link on torch: bits -> DAC -> laser + MZM/PM -> fiber /
EDFA / DBP / DM / BPF stages -> photodiode -> Bessel LPF -> optional ADC ->
slot samples, and the receivers on the device: OOK (eye metrology ->
threshold -> slicer -> error count), M-PPM soft and hard, and both as WDM
sweeps over independent channels.

Port of ``opticomlib_tpu.link`` (``LinkSpec``, the stage specs,
``build_link``, ``LinkProgram.fn`` / ``run`` / ``eye`` / ``dsp`` /
``dsp_ppm`` / ``dsp_wdm`` / ``dsp_wdm_ppm``).  The physics and the order of
operations are the JAX program's; what differs:

* ``LinkProgram`` is an ``nn.Module`` whose spectral constants (``Hp``,
  ``phi_w_*``, ``phi_dm_*``, ``H2_bpf_*``, ``H2_pd``, ``df_phase``) are
  registered buffers in complex64 / float32 on the device given to
  :func:`build_link` (default: ``gv``'s device, the card), named as the JAX
  program names its constants.
* Noise draws come from a ``torch.Generator`` on that device, seeded by
  ``seed=``.  Torch cannot reproduce JAX's threefry keys, so ``forward``,
  ``run`` and ``dsp`` take ``noise=``, a dict of unit-normal draws consumed
  in the JAX key-stream order: ``"phase"`` and ``"rin"`` ``(n,)`` (laser),
  ``"ase"`` one ``(4, n)`` array per noisy EDFA in the order the EDFAs
  run (``RepeatSpec`` spans unrolled), ``"thermal"`` and ``"shot"``
  ``(n,)``, and for the hard PPM receiver ``"hdd"``, the ``(n_sym, M)``
  uniform draws of its symbol repair.  A sweep takes a list of such dicts,
  one a channel.
* The program runs eagerly: ``RepeatSpec`` is a Python loop over its spans,
  and the adaptive fiber loops sync with the host once per step.
* A WDM sweep runs the chain one channel at a time (channel ``c`` is the
  chain of ``seed + c``, with its own step count), keeps each channel's
  receiver window, and runs the receivers on the stacked windows: the KDE
  histograms of all channels are one kernel launch.  Each channel is a
  ``sweep.channel`` span (``channel``, ``steps``) around its chain's
  spans, and :data:`SWEEP_COUNTS` counts the sweeps and their channels on
  the host.  With ``mesh=`` each rank of the mesh runs its block of the
  channels and the per-channel results are gathered
  (``torch.distributed``).
* ``build_link(mesh=...)`` returns the sharded program of
  :mod:`opticomlib_tpu_torch.link_sharded`, which runs this module's chain
  (TX, stages, fiber dispatch, PD/LPF/ADC: ``_LinkChain``) on each rank's
  block, ``build_link(span_mesh=...)`` the span-pipelined one of
  :mod:`opticomlib_tpu_torch.link_pipeline`.

Typical use::

    spec = LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16,
                    pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                    stages=(FiberSpec(length=50, alpha=0.2, beta_2=-21,
                                      gamma=1.3),
                            EDFASpec(G=10, NF=5)), pd_BW=7.5e9)
    prog = build_link(spec, n_bits=2**18,
                      params=SimParams.create(sps=64, R=10e9), device="cuda")
    res = prog.dsp(bits=prbs(15, length=2**18)[0], seed=3)
    res.ber, res.threshold, res.n_steps
"""
from __future__ import annotations

import itertools
import math
import warnings
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.constants import e, k as kB, pi

from .eyediag import Eye
from .ops import filters, kernels, pulses, ssfm
from .models.ppm import (PPM_ENCODER, hdd_positions, positions_to_bits,
                         sdd_positions)
from .ops.eyeana import (TRACE_KEYS, _at, _shortest_int_masked,
                         eye_metrics, eye_scalars, eye_window, linspace)
from .ops.eyeana import pack_rows as _pack_rows
from .ops.eyeana import unpack_rows as _unpack_rows
from .ops.noise import as_draw, ase_sigma, gaussian, wiener_phase
from .ops.prbs import prbs
from .params import SimParams, check_device, current_device, resolve_params
from .signals import BinarySequence, ElectricalSignal
from .utils.analysis import idb, idbm
from .utils.profiling import span

__all__ = ["FiberSpec", "DBPSpec", "EDFASpec", "DMSpec", "BPFSpec",
           "RepeatSpec", "LinkSpec", "LinkProgram", "build_link",
           "SWEEP_COUNTS"]

f32 = np.float32

#: the WDM sweeps run one channel at a time (:meth:`LinkProgram._sweep`):
#: the sweeps made and the channels they ran, counted on the host
SWEEP_COUNTS = {"sweeps": 0, "channels": 0}


def _warn_rin(bad_channels=None):
    """The RuntimeWarning for a clamped RIN draw (``rin_ok`` False): the
    program clamps ``1 + rin`` at 0 where the staged LASER, like the
    reference (devices.py:492-500), raises.  ``bad_channels``: the channel
    indices, for the sweeps."""
    where = ("" if bad_channels is None
             else f" on channel(s) {list(bad_channels)}")
    warnings.warn(
        f"RIN draw crossed -1 and was clamped to dark{where} (the staged "
        "LASER raises here, reference devices.py:492-500); decrease `rin` "
        "or change the seed.", RuntimeWarning, stacklevel=3)


def _adc_quantize(v: torch.Tensor, bits: int) -> torch.Tensor:
    """In-graph ADC: uniform quantisation over the robust 99.99 %
    shortest-interval range (reference devices.py:1616-1627).  The range
    stays on the device; the quantiser is the ``adc_quantize`` kernel in
    link mode (half-to-even codes, no clip)."""
    lo, hi = _shortest_int_masked(v, torch.ones_like(v, dtype=torch.bool),
                                  99.99)
    return kernels.adc_quantize_link(v, lo, hi, bits)


def _injected(noise: Optional[dict], device):
    """``draw(name, i=None)``: the injected unit draws ``noise[name]`` (its
    ``i``-th array for a list) as float32 on ``device``; ``None`` without
    ``noise``."""
    def draw(name, i=None):
        if noise is None:
            return None
        return as_draw(noise[name] if i is None else noise[name][i], device)
    return draw


# ---------------------------------------------------------------------------
# stage and link specs (copied from opticomlib_tpu.link)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FiberSpec:
    """One fiber span (reference devices.py:1038-1206).  ``h=None`` adapts
    the step (``phi_max`` for the reference scheme, the local-error target
    ``tol`` for ``"o4"`` and ``"local_error"``); a fixed ``h`` runs a fixed
    schedule (``"reference"`` or the 4th-order ``"o4"``)."""
    length: float                 # [km]
    alpha: float = 0.0            # [dB/km]
    beta_2: float = 0.0           # [ps^2/km]
    beta_3: float = 0.0           # [ps^3/km]
    gamma: float = 0.0            # [1/W/km]
    phi_max: float = 0.01         # adaptive max NL phase [rad]
    h: Optional[float] = None     # fixed step [km]; None -> adaptive
    method: str = "reference"     # 'reference' | 'o4' | 'local_error'
    tol: float = 1e-5             # o4 / local_error local-error target

    def __post_init__(self):
        if self.length <= 0:
            raise ValueError("FiberSpec.length must be > 0 km")
        if self.phi_max <= 0:
            raise ValueError("FiberSpec.phi_max must be > 0")
        if self.h is not None and self.h <= 0:
            raise ValueError("FiberSpec.h must be > 0 km (or None)")
        if self.method not in ("reference", "o4", "local_error"):
            raise ValueError(
                "FiberSpec.method must be 'reference', 'o4' or "
                "'local_error'")
        if self.tol <= 0:
            raise ValueError("FiberSpec.tol must be > 0")
        if self.method == "local_error" and self.h is not None:
            raise ValueError(
                "FiberSpec(method='local_error') is adaptive; give tol, "
                "not h (use method='o4' for a fixed-step scheme)")


@dataclass(frozen=True)
class DBPSpec(FiberSpec):
    """Digital back-propagation span: the fiber physics with every operator
    sign flipped (reference devices.py:1280-1283).  ``undo_gain_dB`` is
    divided out of the field before the backward pass (set it to the span
    amplifier's gain)."""
    undo_gain_dB: float = 0.0


@dataclass(frozen=True)
class EDFASpec:
    """Flat-gain amplifier + 2-pol ASE (reference devices.py:829-942).
    ``NF=None`` disables the ASE draw (a pure field scale; negative ``G``
    attenuates).  ``BW`` adds the output band-pass (zero-phase Bessel
    ``|H|^2``, reference devices.py:938-941)."""
    G: float                      # gain [dB]
    NF: Optional[float] = None    # noise figure [dB]; None -> no ASE
    BW: Optional[float] = None    # optional output optical filter [Hz]
    filt_order: int = 4

    def __post_init__(self):
        if self.BW is not None and self.BW <= 0:
            raise ValueError("EDFASpec.BW must be > 0 Hz (or None)")


@dataclass(frozen=True)
class DMSpec:
    """Dispersive medium ``H = exp(j*w^2*D/2)``, ``D`` the accumulated GVD
    [ps^2] (reference devices.py:945-1035); ``D = -beta_2*length``
    compensates a span."""
    D: float                      # accumulated dispersion [ps^2]


@dataclass(frozen=True)
class BPFSpec:
    """Optical band-pass: zero-phase Bessel ``|H|^2`` of full bandwidth
    ``BW`` (baseband low-pass at BW/2, reference devices.py:788-826)."""
    BW: float                     # full optical bandwidth [Hz]
    n: int = 4                    # filter order

    def __post_init__(self):
        if self.BW <= 0:
            raise ValueError("BPFSpec.BW must be > 0 Hz")


@dataclass(frozen=True)
class RepeatSpec:
    """``n`` repetitions of a stage block (the 20 x 80 km configs).  The
    field is promoted to 2 polarisations before the first span when the
    block holds a noisy EDFA."""
    n: int
    stages: Tuple = ()

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("RepeatSpec.n must be >= 1")
        if not self.stages:
            raise ValueError("RepeatSpec.stages must be non-empty")
        for st in self.stages:
            if isinstance(st, RepeatSpec):
                raise ValueError("RepeatSpec cannot nest")
            if not isinstance(st, (FiberSpec, EDFASpec, DMSpec, BPFSpec)):
                raise ValueError(f"unsupported stage in RepeatSpec: {st!r}")


@dataclass(frozen=True)
class LinkSpec:
    """Full-link configuration (TX + channel stages + RX); field semantics
    match the JAX package's ``LinkSpec`` (DAC/LASER/MZM: reference
    devices.py:185-785; PD: devices.py:1378-1555; ADC: 1558-1632)."""
    # --- DAC ---
    pulse_shape: str = "gaussian"         # 'nrz' | 'gaussian' | 'rcos'
    pulse_kwargs: Tuple = ()              # (('m', 2), ('c', 0.0), ...)
    pulse_span: int = 32                  # FIR span [slots]
    Vpp: float = 1.0
    offset: float = 0.0
    coupling: str = "DC"                  # 'DC' | 'AC'
    # --- LASER ---
    P0: float = 0.0                       # [dBm]
    lw: Optional[float] = None            # linewidth [Hz]
    rin: Optional[float] = None           # RIN [dB/Hz]
    df: Optional[float] = None            # frequency offset [Hz]
    # --- modulator ---
    modulator: str = "mzm"                # 'mzm' | 'pm'
    bias: float = 0.0
    Vpi: float = 5.0
    loss_dB: float = 0.0
    ER_dB: float = 26.0
    # --- channel ---
    stages: Tuple = ()
    # --- PD ---
    pd_BW: float = 7.5e9                  # electrical bandwidth [Hz]
    pd_r: float = 1.0                     # responsivity [A/W]
    pd_T: float = 300.0                   # temperature [K]
    pd_R_load: float = 50.0               # load resistance [ohm]
    pd_Fn: float = 0.0                    # electrical noise figure [dB]
    i_dark: float = 10e-9                 # dark current [A]
    include_thermal: bool = True
    include_shot: bool = True
    lpf_order: int = 4
    # --- ADC ---
    adc_bits: Optional[int] = None        # None -> no quantization
    # --- sampling ---
    sampler_instant: Optional[int] = None  # default sps//2 (ook.DSP)

    def __post_init__(self):
        if self.pulse_shape.lower() not in ("nrz", "gaussian", "rcos"):
            raise ValueError(
                f"pulse_shape must be 'nrz', 'gaussian' or 'rcos', got "
                f"{self.pulse_shape!r}")
        if self.coupling.strip().upper() not in ("AC", "DC"):
            raise ValueError(
                f"coupling must be 'AC' or 'DC', got {self.coupling!r}")
        if self.modulator.lower() not in ("mzm", "pm"):
            raise ValueError(
                f"modulator must be 'mzm' or 'pm', got {self.modulator!r}")
        if self.Vpi <= 0:
            raise ValueError("Vpi must be > 0")
        if self.pd_BW <= 0:
            raise ValueError("pd_BW must be > 0 Hz")
        if self.pulse_span < 1:
            raise ValueError("pulse_span must be >= 1 slot")
        if self.adc_bits is not None and not 1 <= int(self.adc_bits) <= 16:
            raise ValueError("adc_bits must be in [1, 16] (or None)")
        for st in self.stages:
            if not isinstance(st, (FiberSpec, EDFASpec, DMSpec, BPFSpec,
                                   RepeatSpec)):
                raise ValueError(
                    f"unsupported stage {st!r}; expected FiberSpec/DBPSpec/"
                    "EDFASpec/DMSpec/BPFSpec/RepeatSpec")
        dict(self.pulse_kwargs)  # must be (('key', val), ...) pairs


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------
def _pulse_taps(spec: LinkSpec, sps: int) -> np.ndarray:
    kw = dict(spec.pulse_kwargs)
    shape = spec.pulse_shape.lower()
    span = int(spec.pulse_span)
    if shape == "nrz":
        return pulses.nrz_pulse(span=span, sps=sps, T=kw.get("T", 1))
    if shape == "gaussian":
        hp = pulses.gauss_pulse(span=span, sps=sps, T=kw.get("T", 1),
                                m=kw.get("m", 1), c=kw.get("c", 0.0))
        return hp.real if kw.get("c", 0.0) == 0 else hp
    if shape == "rcos":
        return pulses.rcos_pulse(beta=kw.get("beta", 0.25), span=span,
                                 sps=sps, shape=kw.get("rcos_type", "normal"))
    raise ValueError(f"unknown pulse_shape {spec.pulse_shape!r}")


def _circular_zero_phase_spectrum(h: np.ndarray, n: int) -> np.ndarray:
    """FFT spectrum of the kernel ``h`` centered at index 0 (zero phase),
    for length-``n`` circular convolution equivalent to 'same' linear
    convolution away from the edges."""
    m = h.size
    if m > n:
        raise ValueError(f"pulse span ({m} taps) exceeds waveform ({n})")
    buf = np.zeros(n, dtype=np.complex128 if np.iscomplexobj(h) else
                   np.float64)
    buf[:m] = h
    buf = np.roll(buf, -((m - 1) // 2))
    return np.fft.fft(buf).astype(np.complex64)


def _stage_plan(stages, f0: float, fs: float, *, fiber_extra, dm_const,
                bpf_name):
    """Per-stage constants from the specs, shared by both link programs
    (:class:`LinkProgram` and the sharded
    :class:`~opticomlib_tpu_torch.link_sharded.ShardedLinkProgram`; the JAX
    package's ``_stage_plan``), so the stage semantics live in one place.
    A program gives only its spectral arrays: ``fiber_extra(fiber)`` and
    ``dm_const(dm)`` return extra entries of the stage's dict (a registered
    buffer's name, or what the stage evaluates per rank), ``bpf_name(order,
    BW)`` registers a ``|H|^2`` response and returns its name; all are
    called in stage order."""
    def one(st):
        if isinstance(st, FiberSpec):  # incl. DBPSpec
            cc = {"kind": "fiber",
                  "sgn": -1.0 if isinstance(st, DBPSpec) else 1.0,
                  "a_km": ssfm.alpha_per_km(st.alpha),
                  "hs": (None if st.h is None else
                         ssfm.ssfm_step_schedule(st.length, st.h)),
                  "method": st.method,
                  "linear_only": (st.gamma == 0
                                  or (st.beta_2 == 0 and st.beta_3 == 0))}
            if isinstance(st, DBPSpec) and st.undo_gain_dB:
                cc["pre_scale"] = float(idb(-st.undo_gain_dB) ** 0.5)
            cc.update(fiber_extra(st))
            return cc
        if isinstance(st, EDFASpec):
            cc = {"kind": "edfa", "sqrtG": float(idb(st.G) ** 0.5)}
            if st.NF is not None:
                if st.G < 0:
                    raise ValueError(
                        "EDFASpec with ASE (NF set) needs G >= 0 dB")
                cc["sigma_ase"] = ase_sigma(st.G, st.NF, f0, fs)
            if st.BW is not None:
                cc["H2_name"] = bpf_name(st.filt_order, st.BW)
            return cc
        if isinstance(st, DMSpec):
            return {"kind": "dm", **dm_const(st)}
        if isinstance(st, BPFSpec):
            return {"kind": "bpf", "H2_name": bpf_name(st.n, st.BW)}
        if isinstance(st, RepeatSpec):
            return {"kind": "repeat", "n": st.n,
                    "sub": tuple(one(s) for s in st.stages),
                    "needs_ase": any(
                        isinstance(s, EDFASpec) and s.NF is not None
                        for s in st.stages)}
        raise ValueError(f"unsupported stage {st!r}")

    return [one(s) for s in stages]


def _promote_2pol(f: torch.Tensor, lead: int) -> torch.Tensor:
    """A 1-pol field ``(..., n)`` with ``lead`` leading channel axes as the
    first row of a 2-pol field ``(..., 2, n)``."""
    return (torch.stack([f, torch.zeros_like(f)], dim=lead)
            if f.ndim == lead + 1 else f)


def _ook_decide(m, slots, bits_f32):
    """THRESHOLD_EST (the 1000-point scan of ``0.5*[Q((mu1-r)/s1) +
    Q((r-mu0)/s0)]``, in log space so high-SNR tails do not underflow to a
    flat zero) -> slicer -> error count, from one channel's eye scalars
    (reference ook.py:22-60, 135-218)."""
    with span("rx.decide"):
        r = linspace(m["mu0"], m["mu1"], 1000)
        lq1 = torch.special.log_ndtr(-(m["mu1"] - r) / m["s1"])
        lq0 = torch.special.log_ndtr(-(r - m["mu0"]) / m["s0"])
        rth = _at(r, torch.argmin(torch.logaddexp(lq1, lq0)))
        n_err = ((slots > rth) != (bits_f32 > 0.5)).sum()
    return rth, n_err


def _ook_rx_ingraph(v, slots, bits_f32, sps, nslots, sps_resamp):
    """OOK receiver on the device: eye metrology (:func:`eye_scalars`) ->
    :func:`_ook_decide` (reference ook.py:63-132).  Returns
    ``(EyeScalars, rth, n_err)``, nothing read back."""
    with span("rx.eye") as sp:
        eye = eye_scalars(v, sps, nslots, sps_resamp)
        sp.set(graph=eye.how)
    return (eye,) + _ook_decide(eye.m, slots, bits_f32)


def _ppm_hard_decide(m, slot_samp, info_bits, M, uniform):
    """KDE threshold (falling back to the log-space M-PPM THRESHOLD_EST
    scan, reference ppm.py:261-305, where the KDE fails) -> slicer -> HDD
    repair scored by ``uniform`` -> decode -> error count, from one
    channel's eye scalars (reference ppm.py:390-405, 419-577).  Returns
    ``(rth, n_err, n_rep)``, ``n_rep`` the symbols the repair had to
    decide (zero, or two or more, slots above the threshold)."""
    with span("rx.decide"):
        # argmin 1 - Q((r-mu1)/s1) * (1-Q((r-mu0)/s0))^(M-1) == argmax
        # log Q((r-mu1)/s1) + (M-1) log(1-Q((r-mu0)/s0)),
        # log Q(x) = log_ndtr(-x)
        r = linspace(m["mu0"], m["mu1"], 1000)
        log_a = (torch.special.log_ndtr((m["mu1"] - r) / m["s1"])
                 + (M - 1) * torch.special.log_ndtr((r - m["mu0"]) / m["s0"]))
        rth_scan = _at(r, torch.argmax(log_a))
        rth = torch.where(torch.isnan(m["threshold"]), rth_scan,
                          m["threshold"])
        on = (slot_samp > rth).to(torch.float32)
        n_rep = (on.reshape(-1, M).sum(1) != 1).sum()
        rx_bits = positions_to_bits(hdd_positions(on, M, uniform), M)
        return rth, (rx_bits != info_bits.to(torch.uint8)).sum(), n_rep


def _ppm_hard_rx_ingraph(v, slot_samp, info_bits, M, sps, nslots,
                         sps_resamp, uniform):
    """Hard-decision M-PPM receiver on the device: eye metrology ->
    :func:`_ppm_hard_decide`.  Returns ``(EyeScalars, rth, n_err,
    n_rep)``, nothing read back."""
    with span("rx.eye") as sp:
        eye = eye_scalars(v, sps, nslots, sps_resamp)
        sp.set(graph=eye.how)
    return (eye,) + _ppm_hard_decide(eye.m, slot_samp, info_bits, M,
                                     uniform)


def _ppm_soft_errors(slot_samp, info_bits, M):
    with span("rx.decide"):
        rx_bits = positions_to_bits(sdd_positions(slot_samp, M), M)
        return (rx_bits != info_bits.to(torch.uint8)).sum()


def _read_back(eye=None, **cols) -> dict:
    """One channel's results in one device-to-host copy: the packed row of
    ``eye`` (an :class:`~opticomlib_tpu_torch.ops.eyeana.EyeScalars` of one
    channel, or None) and the tensors ``cols``.  Returns every column as a
    NumPy scalar or array of its dtype."""
    rows, layout = _pack_rows({k: v.reshape((1,) + v.shape)
                               for k, v in cols.items()})
    if eye is not None:
        rows, layout = torch.cat([eye.rows, rows], 1), eye.layout + layout
    return {k: v[0] for k, v in _unpack_rows(rows.cpu().numpy(),
                                             layout).items()}


def _eye_to_host(m: dict, dt: float, host: dict) -> Eye:
    """Eye metrics as an :class:`Eye`: 0-d tensors as Python numbers, the
    traces (when present) left as tensors on their device, other tensors as
    NumPy arrays; NaN ``threshold``/``y_left``/``y_right`` as ``None``.
    ``host``: the values of ``m``'s tensors, read back
    (:func:`_read_back`)."""
    res = {}
    for k, val in m.items():
        if isinstance(val, torch.Tensor) and k not in TRACE_KEYS:
            val = host[k].item() if host[k].ndim == 0 else host[k]
        res[k] = val
    for k in ("threshold", "y_left", "y_right"):
        if res.get(k) is not None and np.isnan(res[k]):
            res[k] = None
    res["dt"] = dt
    return Eye(res)


def _steps_rows(steps, device) -> torch.Tensor:
    """Step counts, one tuple a channel, as a ``(C, stages)`` tensor."""
    return torch.tensor([list(s) for s in steps], dtype=torch.int64,
                        device=device).reshape(len(steps), -1)


def _ook_sweep_rows(wins, slots, bits_f32, sps, nslots, sps_resamp,
                    extra: dict):
    """The OOK receivers of ``C`` channels: eye metrology on the stacked
    windows ``(C, W)`` (the KDE histograms of all channels are one kernel
    launch), then per channel the threshold scan, slicer and error count on
    its slots ``(C, n_bits)``.  Returns :func:`_pack_rows` of the eye
    scalars, ``rth``, ``n_err`` and the ``extra`` columns, and how the eye
    ran (:class:`~opticomlib_tpu_torch.ops.eyeana.EyeScalars`' ``how``)."""
    eye = eye_scalars(wins, sps, nslots, sps_resamp)
    rth, n_err = [], []
    for c in range(wins.shape[0]):
        r, e = _ook_decide({k: eye.m[k][c]
                            for k in ("mu0", "mu1", "s0", "s1")},
                           slots[c], bits_f32[c])
        rth.append(r)
        n_err.append(e)
    rows, layout = _pack_rows(dict(rth=torch.stack(rth),
                                   n_err=torch.stack(n_err), **extra))
    return torch.cat([eye.rows, rows], 1), eye.layout + layout, eye.how


def _ppm_sweep_rows(wins, slots, info, M, decision, sps, nslots,
                    sps_resamp, uniform, extra: dict):
    """The M-PPM receivers of ``C`` channels (soft: per-symbol argmax;
    hard: eye metrology on the stacked windows, one histogram launch, then
    per channel :func:`_ppm_hard_decide` with ``uniform(c)`` as its HDD
    scores).  Returns :func:`_pack_rows` of ``rth``, ``n_err``, for the
    hard receiver ``n_rep``, and the ``extra`` columns."""
    if decision == "hard":
        with span("rx.eye") as sp:
            eye = eye_scalars(wins, sps, nslots, sps_resamp)
            sp.set(graph=eye.how)
        m = eye.m
    rth, n_err, n_rep = [], [], []
    for c in range(slots.shape[0]):
        if decision == "soft":
            r = torch.full((), torch.nan, device=slots.device)
            e = _ppm_soft_errors(slots[c], info[c], M)
        else:
            m_c = {k: m[k][c] for k in ("mu0", "mu1", "s0", "s1",
                                        "threshold")}
            r, e, p = _ppm_hard_decide(m_c, slots[c], info[c], M,
                                       uniform(c))
            n_rep.append(p)
        rth.append(r)
        n_err.append(e)
    cols = dict(rth=torch.stack(rth), n_err=torch.stack(n_err))
    if n_rep:
        cols["n_rep"] = torch.stack(n_rep)
    return _pack_rows(dict(cols, **extra))


def _hdd_uniform(seed: int, n_sym: int, M: int, noise, device):
    """The ``(n_sym, M)`` uniform scores of the HDD symbol repair:
    ``noise["hdd"]`` where given, else drawn from a generator keyed by the
    link seed (its own stream, so the chain's draws do not move)."""
    if noise is not None and "hdd" in noise:
        u = noise["hdd"]
        if not isinstance(u, torch.Tensor):
            u = torch.from_numpy(np.array(u, dtype=np.float32))
        return u.to(device=device, dtype=torch.float32).reshape(n_sym, M)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 2**16 + 0x504D)
    return torch.rand((n_sym, M), generator=gen, device=device,
                      dtype=torch.float32)


def _ppm_shape(n_bits: int, M: int, decision: str):
    """Validated ``(decision, bits a symbol, symbols)`` of an M-PPM
    receiver on ``n_bits`` slots."""
    decision = decision.lower()
    if decision not in ("soft", "hard"):
        raise ValueError('`decision` must be "hard" or "soft"')
    if M & (M - 1) != 0 or M < 2:
        raise ValueError("`M` must be a power of 2.")
    if n_bits % M != 0:
        raise ValueError(
            f"link carries {n_bits} slots, not a multiple of M={M}")
    return decision, int(math.log2(M)), n_bits // M


def _gathered_rows(rows: torch.Tensor, layout, mesh, axis) -> dict:
    """The packed per-channel results of every channel, read back once:
    gathered along ``axis`` of ``mesh`` first (``mesh=None`` or
    ``axis=None``: the rows are all of them already)."""
    if mesh is not None:
        rows = mesh.gather_rows(rows, axis)
    return _unpack_rows(rows.cpu().numpy(), layout)


def _sweep_bits(bits, n_channels: int, width: int, prbs_order: int):
    """A sweep's bits, ``(n_channels, width)``: ``bits`` checked, or
    consecutive PRBS segments."""
    if n_channels < 1:
        raise ValueError("n_channels must be >= 1")
    if bits is None:
        bits = prbs(prbs_order, length=n_channels * width)[0]
        bits = bits.reshape(n_channels, width)
    bits = np.asarray(bits)
    if bits.shape != (n_channels, width):
        raise ValueError(
            f"bits must have shape {(n_channels, width)}, got {bits.shape}")
    return bits


def _sweep_result(host_rows: dict, n_channels: int, bits, per_channel_bits):
    """What both sweeps return of every channel: errors, BER, the RIN flags
    (warning on a clamped draw) and the step counts."""
    n_err = host_rows["n_err"].astype(np.int64)
    rin_ok = host_rows["rin_ok"] > 0
    if not rin_ok.all():
        _warn_rin(np.flatnonzero(~rin_ok).tolist())
    return dict(ber=n_err / per_channel_bits, n_errors=n_err,
                n_channels=n_channels, tx=bits.astype(np.uint8),
                rin_ok=rin_ok,
                n_steps=[tuple(int(x) for x in row)
                         for row in host_rows["steps"]])


def _ppm_result(host_rows: dict, M: int, decision: str) -> dict:
    """What every M-PPM sweep returns besides :func:`_sweep_result`: ``M``,
    the decision, the thresholds and ``n_repaired`` (``None`` for the soft
    receiver)."""
    rth, n_rep = host_rows["rth"], host_rows.get("n_rep")
    return dict(M=M, decision=decision,
                threshold=None if np.isnan(rth).all() else rth,
                n_repaired=None if n_rep is None else n_rep.astype(np.int64))


# ---------------------------------------------------------------------------
# the chain, and the program
# ---------------------------------------------------------------------------
class _LinkChain(torch.nn.Module):
    """The link's physics, written once for :class:`LinkProgram` and the
    sharded program
    (:class:`~opticomlib_tpu_torch.link_sharded.ShardedLinkProgram`): DAC ->
    laser -> MZM/PM, the stages (fiber dispatch, EDFA, DM, BPF), photodiode
    -> LPF -> ADC.  The field carries ``_lead`` leading channel axes:
    ``(n,)`` / ``(2, n)`` on one device, ``(lc, B)`` / ``(lc, 2, B)`` on a
    rank of the sharded program.  A program supplies what it does
    differently:

    * ``_spectral(x, H)``: the spectral multiply by ``H`` (real in, real
      out); ``_ssfm_spectral`` / ``_ssfm_sum``: the split-step loops'
      ``spectral`` and ``reduce_sum`` hooks (None: their own FFT and sums);
    * ``_over_time(x, op)``: ``"mean"`` or ``"min"`` over the time axis, one
      a channel, shaped to broadcast against ``x``;
    * ``_fiber_phase(st, cc, neg)`` and ``_dm_factor(cc)``: a fiber's
      dispersion phase rate (``neg``: the call's cache of DBP phases) and a
      DM stage's spectral factor, in the program's layout;
    * ``_adaptive(f, phi_w, st, g_nl, a_lin)``: the phi_max-adaptive solve,
      ``(field, steps)``;
    * ``_adc(v, bits)``: the ADC;
    * the draws of a call, as callables: ``walk(sigma)`` the laser's Wiener
      phase, ``normal(name, sigma)`` ``sigma * N(0, 1)`` for ``"rin"``,
      ``"thermal"`` and ``"shot"``, ``ase(sigma)`` the next noisy EDFA's
      ``(..., 4, time)`` draws."""
    _lead = 0
    _ssfm_spectral = None
    _ssfm_sum = None

    def _set_scalars(self, mine=slice(None)) -> None:
        """The laser, modulator and photodiode constants; registers the
        frequency offset's phase (``mine``: this rank's samples of it)."""
        spec, n, fs = self.spec, self.n, self.params.fs
        self.sigma_ph = (float(np.sqrt(2 * pi * spec.lw * (1.0 / fs)))
                         if spec.lw and spec.lw > 0 else 0.0)
        self.sigma_rin = (float(np.sqrt(idb(spec.rin) * fs))
                          if spec.rin is not None else 0.0)
        # the expected minimum of n N(0, sigma) draws is about
        # -sigma*sqrt(2 ln n): refuse a RIN whose 1+rin would cross 0
        if self.sigma_rin * math.sqrt(2 * math.log(max(n, 2))) >= 1.0:
            raise ValueError(
                "Noise power is to high, try decrease RIN parameter.")
        if spec.df:
            # reduced mod 2*pi in float64 before the float32 cast: at large
            # n*df the raw phase reaches radians of float32 ulp
            t_axis = np.linspace(0.0, n / fs, n, endpoint=True)
            self._buffer("df_phase", np.mod(
                2 * pi * spec.df * t_axis, 2 * pi).astype(np.float32)[mine])
        self.P0_amp = float(np.sqrt(idbm(spec.P0)))
        self.loss_amp = float(idb(-spec.loss_dB) ** 0.5)
        self.eta_half = float(idb(-spec.ER_dB) ** 0.5)
        self.g_scale = float(pi / 2 / spec.Vpi)
        self.S_T = (4 * kB * spec.pd_T * fs / 2 * idb(spec.pd_Fn)
                    / spec.pd_R_load if spec.include_thermal else 0.0)
        self.instant = (spec.sampler_instant if spec.sampler_instant
                        is not None else self.params.sps // 2)

    def _chain(self, transmit, ase, normal):
        """``transmit()`` (the launch field and the ``rin_ok`` flags), the
        stages (``RepeatSpec`` unrolled, the field promoted to 2
        polarisations before a block with a noisy EDFA), then
        :meth:`_receive`.  Returns the voltage, the step count of each fiber
        stage in the order they ran, the field before the photodiode and
        ``rin_ok``."""
        with span("tx"):
            field, rin_ok = transmit()
        neg_phi = {}  # -phi_w of the DBP stages, built once per call
        n_steps = []
        for st, cc in zip(self.spec.stages, self.plan):
            if cc["kind"] != "repeat":
                field = self._stage(field, st, cc, ase, neg_phi, n_steps)
                continue
            if cc["needs_ase"]:
                field = _promote_2pol(field, self._lead)
            for _ in range(cc["n"]):
                for s_st, s_cc in zip(st.stages, cc["sub"]):
                    field = self._stage(field, s_st, s_cc, ase, neg_phi,
                                        n_steps)
        with span("rx.pd"):
            v = self._receive(field, normal)
        return v, n_steps, field, rin_ok

    def _launch(self, bits: torch.Tensor, walk, normal):
        """DAC -> laser -> MZM/PM: the launch field (complex64) and the
        ``rin_ok`` flags (0 where a RIN draw crossed -1 and was clamped) of
        the float32 ``bits``, the laser's draws from ``walk`` (phase) and
        ``normal("rin", sigma)``, in that order."""
        spec, sps = self.spec, self.params.sps

        # --- DAC: zero-stuff upsample + circular pulse shaping ---
        xu = pulses.upsample_zero_stuff(bits.to(torch.float32), sps)
        x = self._spectral(xu, self.Hp)  # drive
        x = x * float(f32(spec.Vpp)) + float(f32(spec.offset))
        if spec.coupling.strip().upper() == "AC":
            x = x - self._over_time(x, "mean")

        # --- LASER: E = amp * exp(i*phase), or the scalar P0_amp ---
        P0_amp = float(f32(self.P0_amp))
        phase = None
        if self.sigma_ph > 0:
            phase = walk(self.sigma_ph)
        if spec.df:
            phase = self.df_phase if phase is None else phase + self.df_phase
        amp = None
        rin_ok = torch.ones(x.shape[:-1], dtype=torch.float32,
                            device=x.device)
        if self.sigma_rin > 0:
            rin = normal("rin", self.sigma_rin)
            # clamp the power at 0 so a tail draw darkens one sample
            # instead of NaN-ing the chain, and flag it
            rin_ok = (self._over_time(rin, "min") > -1.0).to(
                torch.float32).reshape(rin_ok.shape)
            amp = torch.sqrt(torch.clamp(1 + rin, min=0.0)) * P0_amp
        E = None
        if phase is not None:
            E = torch.polar(torch.full_like(phase, P0_amp)
                            if amp is None else amp, phase)
        elif amp is not None:
            E = amp

        # --- modulator ---
        if spec.modulator.lower() == "pm":
            # E*exp(j*pi*u/Vpi) (reference devices.py:513-617); bias, loss
            # and ER do not apply
            g = x * float(f32(pi / spec.Vpi))
            h_t = torch.complex(torch.cos(g), torch.sin(g))
        else:  # MZM (reference devices.py:762-768)
            g = (x + float(f32(spec.bias))) * float(f32(self.g_scale))
            h_t = torch.complex(torch.cos(g), torch.sin(g)
                                * float(f32(self.eta_half)))
            h_t = h_t * float(f32(self.loss_amp))
        return (h_t * P0_amp if E is None else E * h_t), rin_ok

    def _stage(self, f, st, cc, ase, neg_phi, n_steps):
        """Apply one stage other than a repeat: fiber stages append their
        step count to ``n_steps``, noisy EDFAs take ``ase(sigma)``."""
        if cc["kind"] == "fiber":
            with span("fiber", kind="dbp" if cc["sgn"] < 0 else "fiber",
                      method=cc["method"]) as sp:
                fused = ssfm.fused_steps()
                f, steps = self._fiber(f, st, cc, neg_phi)
                sp.set(steps=steps, fused=ssfm.fused_steps() > fused)
            n_steps.append(steps)
            return f
        with span("stage", kind=cc["kind"]):
            if cc["kind"] == "edfa":
                if "sigma_ase" in cc:  # physical 2-pol ASE
                    f = _promote_2pol(f, self._lead) * float(f32(cc["sqrtG"]))
                    d = ase(cc["sigma_ase"])
                    f = f + torch.complex(d[..., :2, :], d[..., 2:, :])
                else:
                    f = f * float(f32(cc["sqrtG"]))
                if "H2_name" in cc:
                    f = self._spectral(f, getattr(self, cc["H2_name"]))
                return f
            if cc["kind"] == "dm":
                return self._spectral(f, self._dm_factor(cc))
            return self._spectral(f, getattr(self, cc["H2_name"]))

    def _fiber(self, f, st: FiberSpec, cc: dict, neg_phi: dict):
        """One span, forward or (DBPSpec: ``sgn = -1``) the sign-flipped
        back-propagation, by its scheme: one exact step (linear only), a
        fixed schedule (Strang or o4), step doubling (o4 or
        ``local_error``) or phi_max-adaptive.  Returns ``(field,
        steps)``."""
        if "pre_scale" in cc:
            f = f * float(f32(cc["pre_scale"]))
        sgn = cc["sgn"]
        phi_w = self._fiber_phase(st, cc, neg_phi)
        g_nl, a_lin = sgn * st.gamma, sgn * cc["a_km"]
        if cc["linear_only"] and cc["hs"] is None:
            # one exact step; nothing to adapt to
            return ssfm.ssfm_scan_inside(f, phi_w, np.asarray(
                [st.length], dtype=np.float32), g_nl, a_lin,
                spectral=self._ssfm_spectral), 1
        if cc["hs"] is not None:
            scan = (ssfm.ssfm_o4_scan_inside if cc["method"] == "o4"
                    else ssfm.ssfm_scan_inside)
            return scan(f, phi_w, cc["hs"], g_nl, a_lin,
                        spectral=self._ssfm_spectral), len(cc["hs"])
        if cc["method"] in ("o4", "local_error"):
            auto = (ssfm.ssfm_o4_auto_inside if cc["method"] == "o4"
                    else ssfm.ssfm_local_error_inside)
            return auto(f, phi_w, st.length, g_nl, st.tol, st.length / 10.0,
                        a_lin, reduce_sum=self._ssfm_sum,
                        spectral=self._ssfm_spectral)
        return self._adaptive(f, phi_w, st, g_nl, a_lin)

    def _receive(self, field: torch.Tensor, normal) -> torch.Tensor:
        """Photodiode -> electrical LPF (zero-phase ``|H|^2``) -> the
        optional ADC: the receiver's voltage, float32, of a 1- or 2-pol
        field (``(n,)`` or ``(2, n)`` on one device).  ``normal(name,
        sigma)`` gives ``sigma * N(0, 1)`` for ``"thermal"`` and
        ``"shot"``, in that order."""
        spec = self.spec

        # --- PD (reference devices.py:1378-1555) ---
        P = field.real ** 2 + field.imag ** 2
        if field.ndim == self._lead + 2:
            P = P.sum(dim=self._lead)
        i_ph = P * float(f32(spec.pd_r))
        i = i_ph
        if spec.include_thermal or spec.include_shot:
            # the reference folds i_dark into the noise track
            i = i + float(f32(spec.i_dark))
        if spec.include_thermal:
            i = i + normal("thermal", self.S_T ** 0.5)
        if spec.include_shot:
            S_N = ((self._over_time(i_ph, "mean") + float(f32(spec.i_dark)))
                   * float(2 * f32(e)) * float(f32(self.params.fs / 2)))
            i = i + normal("shot", torch.sqrt(S_N))

        # --- electrical LPF (zero-phase |H|^2), ADC ---
        v = self._spectral(i * float(f32(spec.pd_R_load)),
                           self.H2_pd).contiguous()
        if spec.adc_bits is not None:
            v = self._adc(v, int(spec.adc_bits))
        return v


class LinkProgram(_LinkChain):
    """The end-to-end link for ``n_bits`` slots on one device.

    ``forward(bits_f32, seed=0, noise=None) -> (v, slots, n_steps[, field],
    rin_ok)``: the filtered (and, with ``adc_bits``, quantised) photodiode
    voltage (n,), its slot samples (n_bits,), the split-step count of each
    fiber stage in the order they run, the optical field before the
    photodiode when built with ``return_field=True``, and a 0-d float32
    flag that is 0 when a RIN draw crossed -1 and was clamped.
    :meth:`run` and :meth:`dsp` are the host conveniences (bits in,
    results out)."""

    def __init__(self, spec: LinkSpec, n_bits: int, params: SimParams,
                 device, return_field: bool = False):
        super().__init__()
        self.spec = spec
        self.n_bits = int(n_bits)
        self.params = params
        self.device = torch.device(device)
        self.return_field = bool(return_field)
        sps = params.sps
        self.n = n = self.n_bits * sps
        fs = params.fs

        self._buffer("Hp", _circular_zero_phase_spectrum(
            _pulse_taps(spec, sps), n))
        self._set_scalars()

        # --- spectral stage constants, named as the JAX program names them:
        # one counter across phi_w, phi_dm and H2_bpf, identical arrays
        # shared ---
        w = 2 * np.pi * np.fft.fftfreq(n) * fs
        names = {}

        def register(prefix, key, build):
            key = (prefix,) + tuple(key)
            if key not in names:
                names[key] = f"{prefix}_{len(names)}"
                self._buffer(names[key], build())
            return names[key]

        self.plan = _stage_plan(
            spec.stages, params.f0, fs,
            fiber_extra=lambda st: {"phi_name": register(
                "phi_w", (st.beta_2, st.beta_3),
                lambda: ssfm.dispersion_phase(w, st.beta_2, st.beta_3))},
            dm_const=lambda st: {"phi_name": register(
                "phi_dm", (st.D,),
                lambda: ((w * 1e-12) ** 2 * st.D / 2).astype(np.float32))},
            bpf_name=lambda order, BW: register(
                "H2_bpf", (order, float(BW)),
                lambda: filters.bessel_filtfilt_response(
                    order, float(BW) / 2, fs, n)))
        self._buffer("H2_pd", filters.bessel_filtfilt_response(
            spec.lpf_order, float(spec.pd_BW), fs, n))

    def _buffer(self, name: str, arr: np.ndarray) -> None:
        # a copy: the filter responses come from an lru_cache, and
        # load_consts writes into the buffers
        self.register_buffer(name, torch.tensor(arr, device=self.device))

    def load_consts(self, consts: dict) -> None:
        """Replace the spectral constants with ``consts`` (name -> tensor,
        e.g. from :func:`opticomlib_tpu_torch.convert.consts_from_jax`).
        Names, shapes and dtypes must match the buffers; a real response
        goes into a complex64 buffer as it is (an exact cast)."""
        bufs = dict(self.named_buffers())
        if set(consts) != set(bufs):
            raise ValueError(f"constants {sorted(consts)} do not match the "
                             f"program's buffers {sorted(bufs)}")
        for name, val in consts.items():
            val = torch.as_tensor(val)
            if bufs[name].dtype == torch.complex64 and val.dtype == \
                    torch.float32:
                val = val.to(torch.complex64)
            if val.shape != bufs[name].shape or val.dtype != bufs[name].dtype:
                raise ValueError(
                    f"{name}: got {val.dtype}{tuple(val.shape)}, expected "
                    f"{bufs[name].dtype}{tuple(bufs[name].shape)}")
            bufs[name].copy_(val)

    # ---- the chain ----
    def forward(self, bits: torch.Tensor, seed: int = 0,
                noise: Optional[dict] = None):
        n = self.n
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        draw = _injected(noise, self.device)
        i_ase = itertools.count()
        v, n_steps, field, rin_ok = self._chain(
            lambda: self._transmit(bits, gen, draw),
            lambda sigma: gaussian((4, n), sigma, gen,
                                   draw("ase", next(i_ase))),
            lambda name, sigma: gaussian((n,), sigma, gen, draw(name)))
        out = (v, v[self.instant::self.params.sps], tuple(n_steps))
        if self.return_field:
            out = out + (field,)
        return out + (rin_ok,)

    def _transmit(self, bits: torch.Tensor, gen: torch.Generator, draw):
        """DAC -> laser -> MZM/PM (:meth:`_launch`): the launch field
        ``(n,)`` complex64 and the ``rin_ok`` flag, the laser's draws taken
        from ``gen`` (phase, then RIN) or ``draw(name)``."""
        n = self.n
        return self._launch(
            bits, lambda sigma: wiener_phase(n, sigma, gen, draw("phase")),
            lambda name, sigma: gaussian((n,), sigma, gen, draw(name)))

    # ---- what the chain asks of one device ----
    _spectral = staticmethod(filters.apply_freq_response)
    _adc = staticmethod(_adc_quantize)

    @staticmethod
    def _over_time(x: torch.Tensor, op: str) -> torch.Tensor:
        return x.mean() if op == "mean" else x.min()

    def _fiber_phase(self, st, cc: dict, neg_phi: dict) -> torch.Tensor:
        phi_w = getattr(self, cc["phi_name"])
        if cc["sgn"] < 0:
            if cc["phi_name"] not in neg_phi:
                neg_phi[cc["phi_name"]] = -phi_w
            phi_w = neg_phi[cc["phi_name"]]
        return phi_w

    def _dm_factor(self, cc: dict) -> torch.Tensor:
        ph = getattr(self, cc["phi_name"])
        return torch.complex(torch.cos(ph), torch.sin(ph))

    @staticmethod
    def _adaptive(f, phi_w, st: FiberSpec, g_nl, a_lin):
        h0 = ssfm._first_step(st.phi_max, g_nl, ssfm.max_power(f), st.length)
        return ssfm.ssfm_while_inside(f, phi_w, st.length, g_nl, st.phi_max,
                                      h0, a_lin, adaptive=True)

    # ---- host conveniences ----
    def _bits(self, bits, prbs_order: int):
        """``bits`` (an array, a ``BinarySequence``; default a PRBS of
        ``prbs_order``) as the transmitted ``BinarySequence`` and as the
        float32 tensor :meth:`forward` takes."""
        if bits is None:
            bits = prbs(prbs_order, length=self.n_bits)[0]
        tx = BinarySequence(np.asarray(bits).reshape(-1))
        if tx.size != self.n_bits:
            raise ValueError(f"need {self.n_bits} bits, got {tx.size}")
        return tx, torch.as_tensor(tx.to_numpy(np.float32),
                                   device=self.device)

    def jitted(self, bits: torch.Tensor, seed: int = 0,
               noise: Optional[dict] = None):
        """``(bits_f32, seed) -> (v, slots, n_steps[, field], rin_ok)``: the
        chain itself, tensors in and tensors out on the program's device,
        with no host convenience around it.  This is :meth:`forward` without
        autograd, under the name the JAX program gives its compiled entry
        (``LinkProgram.jitted``; its ``fn`` is :meth:`forward`).  ``bits``:
        a float32 tensor of ``n_bits`` zeros and ones on the program's
        device."""
        with torch.no_grad():
            return self(bits, seed=seed, noise=noise)

    @torch.no_grad()
    def run(self, bits=None, seed: int = 0, prbs_order: int = 9,
            noise: Optional[dict] = None):
        """Run the chain on ``bits`` (an array or ``BinarySequence`` of
        length ``n_bits``; default: a PRBS of ``prbs_order``).  Returns a
        namespace with ``tx`` (``BinarySequence``), ``v``
        (``ElectricalSignal``, the filtered photodiode voltage, on the
        program's device) and ``slots`` (``ElectricalSignal``, its slot
        samples), ``program``, ``n_steps``, ``rin_ok`` (False when a RIN
        draw was clamped; it also warns), for a program built with
        ``return_field=True`` ``field`` (a tensor), and the helpers
        ``decide(threshold) -> BinarySequence`` and ``ber(threshold=None)``
        (``GET_EYE`` + ``THRESHOLD_EST`` under the current ``gv`` when no
        threshold is given)."""
        tx, bits_f32 = self._bits(bits, prbs_order)
        out = self(bits_f32, seed=seed, noise=noise)
        slots = out[1]
        ns = SimpleNamespace(
            tx=tx, v=ElectricalSignal(out[0]), slots=ElectricalSignal(slots),
            program=self, n_steps=out[2], rin_ok=_rin_ok(out[-1]),
            **({"field": out[3]} if self.return_field else {}))

        def decide(threshold: float) -> BinarySequence:
            return BinarySequence((slots > threshold).to(torch.uint8))

        def ber(threshold: Optional[float] = None) -> float:
            if threshold is None:
                from .devices import GET_EYE
                from .models.ook import THRESHOLD_EST
                threshold = THRESHOLD_EST(GET_EYE(
                    ns.v, nslots=min(8192, self.n_bits)))
            return float(np.mean(decide(threshold).data != tx.data))

        ns.decide, ns.ber = decide, ber
        return ns

    @torch.no_grad()
    def dsp(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = 128,
            noise: Optional[dict] = None):
        """Chain -> GET_EYE -> THRESHOLD_EST -> slicer -> BER, with every
        receiver stage a reduction on the device and only scalars read back
        (mirrors ``models.ook.DSP`` + ``BER_analizer('counter')``).
        Returns a namespace with ``ber``, ``n_errors``, ``threshold``,
        ``eye`` (an :class:`Eye` without traces), ``tx`` (the transmitted
        ``BinarySequence``), ``n_steps`` and ``rin_ok``."""
        with span("call.dsp", n=self.n):
            tx, bits_f32 = self._bits(bits, prbs_order)
            out = self(bits_f32, seed=seed, noise=noise)
            e, rth, n_err = _ook_rx_ingraph(out[0], out[1], bits_f32,
                                            self.params.sps, nslots,
                                            sps_resamp)
            with span("rx.readback"):
                host = _read_back(e, rth=rth, n_err=n_err, rin_ok=out[-1])
                rin_ok = _rin_ok(host["rin_ok"])
                n_err = int(host["n_err"])
                rth = float(host["rth"])
                eye = _eye_to_host(e.m, 1.0 / self.params.fs, host)
        return SimpleNamespace(ber=n_err / self.n_bits, n_errors=n_err,
                               threshold=rth, eye=eye, tx=tx,
                               n_steps=out[2], rin_ok=rin_ok)

    @torch.no_grad()
    def eye(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = None,
            with_traces: bool = False, noise: Optional[dict] = None):
        """Chain -> GET_EYE: the blind eye estimation (reference
        devices.py:1635-1868) runs on the photodiode voltage where it lies,
        and only the scalar eye parameters (mu0/mu1/s0/s1, crossings, t_opt,
        threshold, ER, eye height) are read back.  ``with_traces=True`` also
        returns the rendering traces ``t``/``y``/``y_top``/``y_bot``/
        ``y_25_75`` as tensors on the program's device (``Eye.density``
        bins them there)."""
        _, bits_f32 = self._bits(bits, prbs_order)
        out = self(bits_f32, seed=seed, noise=noise)
        if with_traces:
            m = eye_metrics(out[0], self.params.sps, nslots, sps_resamp)
            host = _read_back(rin_ok=out[-1], **{
                k: v for k, v in m.items() if isinstance(v, torch.Tensor)
                and k not in TRACE_KEYS})
        else:
            e = eye_scalars(out[0], self.params.sps, nslots, sps_resamp)
            m, host = e.m, _read_back(e, rin_ok=out[-1])
        _rin_ok(host["rin_ok"])
        return _eye_to_host(m, 1.0 / self.params.fs, host)

    # ---- M-PPM ----
    @torch.no_grad()
    def dsp_ppm(self, M: int, decision: str = "soft", bits=None,
                seed: int = 0, prbs_order: int = 15, nslots: int = 8192,
                sps_resamp: Optional[int] = None,
                noise: Optional[dict] = None):
        """M-PPM receiver on the device: chain -> decision -> decode -> BER
        (twin of ``models.ppm.DSP`` + ``BER_analizer('counter')``, reference
        ppm.py:309-415, 419-577).

        The link's input sequence is the M-slot one-hot stream (so the
        program is built with ``n_bits = n_symbols * M`` slots); ``bits``
        here are the *information* bits (``n_symbols * log2(M)`` of them,
        PRBS by default), encoded once on the host with ``PPM_ENCODER``.

        * ``decision="soft"``: mid-slot subsample -> per-symbol argmax
          (:func:`~opticomlib_tpu_torch.models.ppm.sdd_positions`).
        * ``decision="hard"``: eye metrology -> KDE threshold (falling back
          to the M-PPM log-space THRESHOLD_EST scan where the KDE fails) ->
          slicer -> HDD repair
          (:func:`~opticomlib_tpu_torch.models.ppm.hdd_positions`): the
          reference's ``np.random`` symbol repair becomes a uniform score a
          slot, ``noise["hdd"]`` or a draw keyed by ``seed``.

        Only ``n_errors``, ``n_repaired``, the threshold and the eye
        scalars are read back, in one copy; ``tx`` is the information bits
        as a ``BinarySequence``.  ``n_repaired`` (hard only, else None):
        the symbols whose slicer output had zero, or two or more, ON slots,
        which the HDD repair decided."""
        decision, k, n_sym = _ppm_shape(self.n_bits, M, decision)
        with span("call.dsp_ppm", n=self.n, M=M, decision=decision) as root:
            if bits is None:
                bits = prbs(prbs_order, length=n_sym * k)[0]
            tx = BinarySequence(np.asarray(bits).reshape(-1))
            if tx.size != n_sym * k:
                raise ValueError(
                    f"need {n_sym * k} information bits for {n_sym} "
                    f"symbols of M={M}, got {tx.size}")
            slots_tx = PPM_ENCODER(tx, M)
            info = torch.as_tensor(tx.data, device=self.device)
            out = self(torch.as_tensor(slots_tx.data.astype(np.float32),
                                       device=self.device), seed=seed,
                       noise=noise)
            eye_obj, rth, n_rep = None, None, None
            if decision == "soft":
                n_err = _ppm_soft_errors(out[1], info, M)
                with span("rx.readback"):
                    host = _read_back(n_err=n_err, rin_ok=out[-1])
            else:
                e, rth, n_err, n_rep = _ppm_hard_rx_ingraph(
                    out[0], out[1], info, M, self.params.sps, nslots,
                    sps_resamp, _hdd_uniform(seed, n_sym, M, noise,
                                             self.device))
                with span("rx.readback"):
                    host = _read_back(e, rth=rth, n_err=n_err, n_rep=n_rep,
                                      rin_ok=out[-1])
                    eye_obj = _eye_to_host(e.m, 1.0 / self.params.fs, host)
                rth = float(host["rth"])
                n_rep = int(host["n_rep"])
                root.set(n_repaired=n_rep)
            rin_ok = _rin_ok(host["rin_ok"])
            n_err = int(host["n_err"])
        return SimpleNamespace(
            ber=n_err / tx.size, n_errors=n_err, n_repaired=n_rep,
            threshold=(None if rth is None or np.isnan(rth) else rth),
            eye=eye_obj, tx=tx, slots_tx=slots_tx, M=M, decision=decision,
            n_steps=out[2], rin_ok=rin_ok)

    # ---- WDM sweeps ----
    def _channels(self, n_channels: int, mesh, axis) -> range:
        """The channels this rank runs: all of them, or with a ``mesh`` its
        contiguous block along ``axis`` (what ``NamedSharding(mesh,
        P(axis))`` gives a device)."""
        if mesh is None:
            return range(n_channels)
        if not hasattr(mesh, "axis"):
            raise TypeError(
                f"mesh must be a mesh of ranks (parallel.fiber.make_mesh, "
                f"make_link_mesh), got {type(mesh).__name__}")
        k, i = mesh.axis(axis).size, mesh.axis(axis).index
        if mesh.device.type != self.device.type:
            raise ValueError(
                f"the program runs on {self.device}, the mesh on "
                f"{mesh.device}: build the link on the mesh's device")
        if n_channels % k:
            raise ValueError(f"{n_channels} channels not divisible by the "
                             f"'{axis}' mesh size {k}")
        return range(i * n_channels // k, (i + 1) * n_channels // k)

    def _sweep(self, inputs, seed: int, noise, nslots: int, mesh,
               axis: str = "wdm"):
        """Run the chain on each row of ``inputs`` that this rank runs
        (:meth:`_channels`; channel ``c`` with ``seed + c`` and
        ``noise[c]``), one channel at a time so the memory is one
        channel's, and keep what the receivers need: the eye window of
        ``v`` and the slot samples, stacked ``(C, ...)``, the step counts
        (a tuple a channel) and the ``rin_ok`` flags ``(C,)``.

        Each channel is a ``sweep.channel`` span (``channel``: its index;
        ``steps``: its step counts, host ints already) around its input's
        copy, its chain (whose ``tx`` / ``fiber`` / ``stage`` / ``rx.pd``
        spans nest in it) and the copies of its window and slots;
        :data:`SWEEP_COUNTS` counts the sweep and its channels.  Neither
        launches, reads back or waits for anything."""
        if noise is not None and len(noise) != len(inputs):
            raise ValueError(
                f"noise must be a list of {len(inputs)} per-channel dicts")
        w = eye_window(self.n, self.params.sps, nslots)
        wins, slots, steps, flags = [], [], [], []
        mine = self._channels(len(inputs), mesh, axis)
        for c in mine:
            with span("sweep.channel", channel=c) as sp:
                out = self(torch.as_tensor(inputs[c], dtype=torch.float32,
                                           device=self.device),
                           seed=seed + c,
                           noise=None if noise is None else noise[c])
                # copies: a view would keep the channel's whole waveform alive
                wins.append(out[0][:w].clone())
                slots.append(out[1].clone())
                sp.set(steps=out[2])
            steps.append(out[2])
            flags.append(out[-1])
        SWEEP_COUNTS["sweeps"] += 1
        SWEEP_COUNTS["channels"] += len(mine)
        return (torch.stack(wins), torch.stack(slots), steps,
                torch.stack(flags))

    @torch.no_grad()
    def dsp_wdm(self, n_channels: int, bits=None, seed: int = 0,
                prbs_order: int = 15, nslots: int = 8192,
                sps_resamp: Optional[int] = None, mesh=None,
                axis: str = "wdm", noise: Optional[list] = None):
        """WDM sweep with per-channel receivers: ``n_channels`` independent
        TX->RX chains + OOK DSP (BASELINE config 5).

        Channel ``c`` runs the chain with its own bits (row ``c`` of
        ``bits``, default: consecutive PRBS segments) and its own noise
        stream (``seed + c``: what ``prog.dsp(seed=seed + c)`` sees, with
        that call's step count).  The receiver is :meth:`dsp`'s, on the
        stacked eye windows: the KDE histograms of all channels are one
        kernel launch, and the results come back as ``(n_channels,)``
        vectors in one read-back.  ``noise``: a list of per-channel draw
        dicts.

        ``mesh`` (a mesh of ranks with an ``axis`` dimension, e.g.
        ``make_mesh(range(world), ("wdm",))``): every rank of the mesh
        makes the same call and runs its contiguous block of the channels
        (``n_channels`` divisible by the axis size), with the seeds and the
        step counts those channels have without a mesh; the per-channel
        results are gathered along ``axis``, so every rank returns all
        ``n_channels``.  The channels need no traffic between the ranks
        until that gather."""
        with span("call.dsp_wdm", n=self.n, channels=n_channels):
            bits = _sweep_bits(bits, n_channels, self.n_bits, prbs_order)
            mine = self._channels(n_channels, mesh, axis)
            wins, slots, steps, flags = self._sweep(bits, seed, noise,
                                                    nslots, mesh, axis)
            with span("rx.eye") as sp:
                rows, layout, how = _ook_sweep_rows(
                    wins, slots, torch.as_tensor(
                        bits[mine].astype(np.float32), device=self.device),
                    self.params.sps, nslots, sps_resamp,
                    dict(rin_ok=flags, steps=_steps_rows(steps,
                                                         self.device)))
                sp.set(graph=how)
            with span("rx.readback"):
                r = _gathered_rows(rows, layout, mesh, axis)
            return SimpleNamespace(
                threshold=r["rth"].astype(np.float32),
                **{k: r[k] for k in ("mu0", "mu1", "s0", "s1", "er",
                                     "eye_h")},
                **_sweep_result(r, n_channels, bits, self.n_bits))

    @torch.no_grad()
    def dsp_wdm_ppm(self, n_channels: int, M: int, decision: str = "soft",
                    bits=None, seed: int = 0, prbs_order: int = 15,
                    mesh=None, axis: str = "wdm", nslots: int = 8192,
                    sps_resamp: Optional[int] = None,
                    noise: Optional[list] = None):
        """M-PPM WDM sweep: ``n_channels`` independent chains + PPM
        receivers, the PPM twin of :meth:`dsp_wdm`.

        * ``decision="soft"``: SDD argmax decision + decode + BER.
        * ``decision="hard"``: per-channel eye metrology on the stacked eye
          windows (one KDE histogram launch) -> KDE/scan threshold ->
          slicer -> HDD repair -> decode + BER (:meth:`dsp_ppm`'s
          receiver; ``nslots``/``sps_resamp`` size the eye window).

        ``bits``: (n_channels, n_sym*log2(M)) *information* bits (PRBS
        segments by default), encoded once on the host with
        ``PPM_ENCODER``.  Channel ``c`` uses the noise stream ``seed + c``
        (``noise``: a list of per-channel draw dicts).  ``mesh``/``axis``
        spread the channels over ranks as for :meth:`dsp_wdm`.
        ``n_repaired``: :meth:`dsp_ppm`'s, one a channel (hard only, else
        None), read back with the rest."""
        decision, k, n_sym = _ppm_shape(self.n_bits, M, decision)
        with span("call.dsp_wdm_ppm", n=self.n, channels=n_channels, M=M,
                  decision=decision) as root:
            bits = _sweep_bits(bits, n_channels, n_sym * k,
                               prbs_order).astype(np.uint8)
            slots_tx = np.stack([PPM_ENCODER(bits[c], M).data.astype(
                np.float32) for c in range(n_channels)])
            mine = self._channels(n_channels, mesh, axis)
            wins, slots, steps, flags = self._sweep(slots_tx, seed, noise,
                                                    nslots, mesh, axis)
            rows, layout = _ppm_sweep_rows(
                wins, slots, torch.as_tensor(bits[mine], device=self.device),
                M, decision, self.params.sps, nslots, sps_resamp,
                lambda c: _hdd_uniform(
                    seed + mine[c], n_sym, M,
                    None if noise is None else noise[mine[c]], self.device),
                dict(rin_ok=flags, steps=_steps_rows(steps, self.device)))
            with span("rx.readback"):
                r = _gathered_rows(rows, layout, mesh, axis)
            out = _ppm_result(r, M, decision)
            if out["n_repaired"] is not None:
                root.set(n_repaired=int(out["n_repaired"].sum()))
            return SimpleNamespace(
                **out, **_sweep_result(r, n_channels, bits, n_sym * k))


def _rin_ok(flag) -> bool:
    """The RIN flag (a 0-d tensor, or its value read back) as a bool;
    warns when a draw was clamped."""
    ok = bool(float(flag) != 0.0)
    if not ok:
        _warn_rin()
    return ok


def build_link(spec: LinkSpec, n_bits: int,
               params: Optional[SimParams] = None,
               return_field: bool = False, mesh=None,
               time_axis: str = "time", wdm_axis: Optional[str] = "wdm",
               span_mesh=None, span_axis: str = "span", *, device=None):
    """Build the link described by ``spec`` for ``n_bits`` slots at the
    given (default: ``gv``'s current) simulation parameters on ``device``
    (``"cuda"``, ``"cuda:1"``, ``"cpu"``...; default: ``gv``'s device, the
    card unless ``gv(device=...)`` says otherwise).  A CUDA device with no
    card present raises: there is no CPU fallback.  ``return_field=True``
    adds the optical field before the photodiode to the program's outputs.

    ``mesh`` (a mesh of ranks with a ``time_axis`` and optionally a
    ``wdm_axis``; :func:`~opticomlib_tpu_torch.parallel.make_link_mesh`)
    builds the **sharded** fused link instead
    (:class:`~opticomlib_tpu_torch.link_sharded.ShardedLinkProgram`, on the
    mesh's device): each waveform's samples spread over the time axis
    (exact pencil-FFT spectral operations, adaptive split-step with an
    all-reduce(max) a step), channels over the wdm axis, the receivers'
    scalars gathered.

    ``span_mesh`` (a 1-D mesh of ranks,
    :func:`~opticomlib_tpu_torch.parallel.make_span_mesh`) builds the
    **pipelined** fused link instead
    (:class:`~opticomlib_tpu_torch.link_pipeline.PipelinedLinkProgram`, on
    the mesh's device): the channel-stage chain (FIBER+EDFA spans, DBP with
    undo-gain, DM, e.g. config 4's 20 x 80 km chain) is spread over the
    ranks of ``span_axis`` and a batch of channels streams through it
    (``dsp_wdm``), TX and RX running on each channel's owner rank."""
    if mesh is not None and span_mesh is not None:
        raise ValueError("pass either mesh= (time/wdm sharding) or "
                         "span_mesh= (span pipelining), not both")
    for m in (mesh, span_mesh):
        if m is not None and device is not None and \
                check_device(device).type != m.device.type:
            raise ValueError(f"device {device} but the mesh computes on "
                             f"{m.device}")
    if span_mesh is not None:
        from .link_pipeline import PipelinedLinkProgram
        return PipelinedLinkProgram(spec, n_bits, resolve_params(params),
                                    span_mesh, span_axis=span_axis)
    if mesh is not None:
        from .link_sharded import ShardedLinkProgram
        return ShardedLinkProgram(spec, n_bits, resolve_params(params), mesh,
                                  time_axis=time_axis, wdm_axis=wdm_axis,
                                  return_field=return_field)
    device = current_device() if device is None else check_device(device)
    params = resolve_params(params)
    with span("setup.build_link", n=int(n_bits) * params.sps):
        return LinkProgram(spec, n_bits, params, device,
                           return_field=return_field)
