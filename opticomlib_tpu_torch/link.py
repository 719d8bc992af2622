"""The fused OOK link on torch: bits -> DAC -> laser + MZM -> fiber / EDFA
stages -> photodiode -> Bessel LPF -> slot samples, and the receiver
(eye metrology -> threshold -> slicer -> error count).

Port of ``opticomlib_tpu.link`` (``LinkSpec``, ``build_link``,
``LinkProgram.fn`` / ``run`` / ``dsp``).  The physics and the order of
operations are the JAX program's; what differs:

* ``LinkProgram`` is an ``nn.Module`` whose spectral constants (``Hp``,
  ``phi_w_*``, ``H2_pd``) are registered buffers in complex64 / float32 on
  the device given to :func:`build_link`.  There is no default device.
* Noise draws come from a ``torch.Generator`` on that device, seeded by
  ``seed=``.  Torch cannot reproduce JAX's threefry keys, so ``forward``,
  ``run`` and ``dsp`` take ``noise=``, a dict of unit-normal draws
  (``"ase"``: one ``(4, n)`` array per noisy EDFA, ``"thermal"`` and
  ``"shot"``: ``(n,)``), consumed in the JAX key-stream order.
* The program runs eagerly; the adaptive fiber loop syncs with the host
  once per step.

Options of the JAX ``LinkSpec`` that this port does not carry yet raise
``NotImplementedError`` naming the ROADMAP item that will port them.

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

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.constants import e, k as kB, pi

from .eyediag import Eye
from .ops import filters, pulses, ssfm
from .ops.eyeana import eye_metrics, linspace
from .ops.noise import ase_sigma, gaussian
from .ops.prbs import prbs
from .params import SimParams
from .utils.analysis import idb, idbm

__all__ = ["FiberSpec", "EDFASpec", "LinkSpec", "LinkProgram", "build_link"]

_EYE_TRACE_KEYS = ("y", "t", "y_top", "y_bot", "y_25_75")
f32 = np.float32


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to opticomlib_tpu_torch yet (ROADMAP.md, "
        f"'Left out of the first slice', item {item})")


# ---------------------------------------------------------------------------
# stage and link specs (copied from opticomlib_tpu.link)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FiberSpec:
    """One fiber span (reference devices.py:1038-1206).  ``h=None`` adapts
    the step to ``phi_max``; a fixed ``h`` runs a fixed schedule.  Only the
    reference scheme (``method="reference"``) is ported."""
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
class EDFASpec:
    """Flat-gain amplifier + 2-pol ASE (reference devices.py:829-942).
    ``NF=None`` disables the ASE draw (a pure field scale)."""
    G: float                      # gain [dB]
    NF: Optional[float] = None    # noise figure [dB]; None -> no ASE
    BW: Optional[float] = None    # optional output optical filter [Hz]
    filt_order: int = 4

    def __post_init__(self):
        if self.BW is not None and self.BW <= 0:
            raise ValueError("EDFASpec.BW must be > 0 Hz (or None)")


@dataclass(frozen=True)
class LinkSpec:
    """Full-link configuration (TX + channel stages + RX); field semantics
    match the JAX package's ``LinkSpec`` (DAC/LASER/MZM: reference
    devices.py:185-785; PD: devices.py:1378-1555)."""
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
        dict(self.pulse_kwargs)  # must be (('key', val), ...) pairs
        # --- options the port does not carry yet ---
        for name in ("lw", "rin", "df"):
            if getattr(self, name):
                raise _not_ported(f"LinkSpec.{name} (laser noise/offset)", 1)
        if self.modulator.lower() == "pm":
            raise _not_ported("LinkSpec(modulator='pm')", 2)
        if self.adc_bits is not None:
            raise _not_ported("LinkSpec.adc_bits (in-graph ADC)", 5)
        for st in self.stages:
            if not isinstance(st, (FiberSpec, EDFASpec)):
                raise _not_ported(
                    f"stage {type(st).__name__} (DMSpec/BPFSpec/DBPSpec/"
                    "RepeatSpec)", 3)


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


def _stage_plan(stages, f0: float, fs: float, phi_name):
    """Per-stage constants from the specs.  ``phi_name(st)`` registers the
    fiber's dispersion phase array and returns its buffer name."""
    plan = []
    for st in stages:
        if isinstance(st, FiberSpec):
            if st.method != "reference":
                raise _not_ported(f"FiberSpec(method={st.method!r})", 4)
            linear_only = st.gamma == 0 or (st.beta_2 == 0
                                            and st.beta_3 == 0)
            if st.h is not None:
                hs = ssfm.ssfm_step_schedule(st.length, st.h)
            elif linear_only:  # one exact step; nothing to adapt to
                hs = np.asarray([st.length], dtype=np.float32)
            else:
                hs = None      # phi_max-adaptive
            plan.append({"kind": "fiber", "hs": hs, "phi_name": phi_name(st),
                         "a_km": ssfm.alpha_per_km(st.alpha)})
        elif isinstance(st, EDFASpec):
            if st.BW is not None:
                raise _not_ported("EDFASpec.BW (output optical filter)", 3)
            cc = {"kind": "edfa", "sqrtG": float(idb(st.G) ** 0.5)}
            if st.NF is not None:
                if st.G < 0:
                    raise ValueError(
                        "EDFASpec with ASE (NF set) needs G >= 0 dB")
                cc["sigma_ase"] = ase_sigma(st.G, st.NF, f0, fs)
            plan.append(cc)
        else:
            raise _not_ported(f"stage {type(st).__name__}", 3)
    return plan


def _ook_rx_ingraph(v, slots, bits_f32, sps, nslots, sps_resamp):
    """OOK receiver on the device: eye metrology -> THRESHOLD_EST (the
    1000-point scan of ``0.5*[Q((mu1-r)/s1) + Q((r-mu0)/s0)]``, in log space
    so high-SNR tails do not underflow to a flat zero) -> slicer -> error
    count (reference ook.py:22-60, 63-132, 135-218)."""
    m = eye_metrics(v, sps=sps, nslots=nslots, sps_resamp=sps_resamp)
    for k in _EYE_TRACE_KEYS:
        m.pop(k, None)
    r = linspace(m["mu0"], m["mu1"], 1000)
    lq1 = torch.special.log_ndtr(-(m["mu1"] - r) / m["s1"])
    lq0 = torch.special.log_ndtr(-(r - m["mu0"]) / m["s0"])
    rth = r[torch.argmin(torch.logaddexp(lq1, lq0))]
    n_err = ((slots > rth) != (bits_f32 > 0.5)).sum()
    return m, rth, n_err


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------
class LinkProgram(torch.nn.Module):
    """The end-to-end link for ``n_bits`` slots on one device.

    ``forward(bits_f32, seed=0, noise=None) -> (v, slots, n_steps)``: the
    filtered photodiode voltage (n,), its slot samples (n_bits,), and the
    split-step count of each fiber stage.  :meth:`run` and :meth:`dsp` are
    the host conveniences (bits in, results out)."""

    def __init__(self, spec: LinkSpec, n_bits: int, params: SimParams,
                 device):
        super().__init__()
        self.spec = spec
        self.n_bits = int(n_bits)
        self.params = params
        self.device = torch.device(device)
        sps = params.sps
        self.n = n = self.n_bits * sps
        fs = params.fs

        self._buffer("Hp", _circular_zero_phase_spectrum(
            _pulse_taps(spec, sps), n))

        w = 2 * np.pi * np.fft.fftfreq(n) * fs
        phi_names = {}  # identical dispersion arrays shared across stages

        def phi_name(st):
            key = (st.beta_2, st.beta_3)
            if key not in phi_names:
                phi_names[key] = f"phi_w_{len(phi_names)}"
                self._buffer(phi_names[key], ssfm.dispersion_phase(
                    w, st.beta_2, st.beta_3))
            return phi_names[key]

        self.plan = _stage_plan(spec.stages, params.f0, fs, phi_name)
        self._buffer("H2_pd", filters.bessel_filtfilt_response(
            spec.lpf_order, float(spec.pd_BW), fs, n))

        self.P0_amp = float(np.sqrt(idbm(spec.P0)))
        self.loss_amp = float(idb(-spec.loss_dB) ** 0.5)
        self.eta_half = float(idb(-spec.ER_dB) ** 0.5)
        self.g_scale = float(pi / 2 / spec.Vpi)
        self.S_T = (4 * kB * spec.pd_T * fs / 2 * idb(spec.pd_Fn)
                    / spec.pd_R_load if spec.include_thermal else 0.0)
        self.instant = (spec.sampler_instant if spec.sampler_instant
                        is not None else sps // 2)

    def _buffer(self, name: str, arr: np.ndarray) -> None:
        # a copy: the filter responses come from an lru_cache, and
        # load_consts writes into the buffers
        self.register_buffer(name, torch.tensor(arr, device=self.device))

    def load_consts(self, consts: dict) -> None:
        """Replace the spectral constants with ``consts`` (name -> tensor,
        e.g. from :func:`opticomlib_tpu_torch.convert.consts_from_jax`).
        Names, shapes and dtypes must match the buffers."""
        bufs = dict(self.named_buffers())
        if set(consts) != set(bufs):
            raise ValueError(f"constants {sorted(consts)} do not match the "
                             f"program's buffers {sorted(bufs)}")
        for name, val in consts.items():
            val = torch.as_tensor(val)
            if val.shape != bufs[name].shape or val.dtype != bufs[name].dtype:
                raise ValueError(
                    f"{name}: got {val.dtype}{tuple(val.shape)}, expected "
                    f"{bufs[name].dtype}{tuple(bufs[name].shape)}")
            bufs[name].copy_(val)

    # ---- the chain ----
    def forward(self, bits: torch.Tensor, seed: int = 0,
                noise: Optional[dict] = None):
        spec, n, sps = self.spec, self.n, self.params.sps
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def draw(name, i=None):
            if noise is None:
                return None
            d = noise[name] if i is None else noise[name][i]
            if not isinstance(d, torch.Tensor):
                d = torch.from_numpy(np.array(d, dtype=np.float32))
            return d.to(device=dev, dtype=torch.float32)

        # --- DAC: zero-stuff upsample + circular pulse shaping ---
        xu = pulses.upsample_zero_stuff(bits.to(torch.float32), sps)
        x = torch.fft.ifft(torch.fft.fft(xu) * self.Hp).real  # MZM drive
        x = x * float(f32(spec.Vpp)) + float(f32(spec.offset))
        if spec.coupling.strip().upper() == "AC":
            x = x - x.mean()

        # --- LASER (no linewidth/RIN/offset in this port) + MZM ---
        g = (x + float(f32(spec.bias))) * float(f32(self.g_scale))
        h_t = torch.complex(torch.cos(g),
                            torch.sin(g) * float(f32(self.eta_half)))
        field = (h_t * float(f32(self.loss_amp))) * float(f32(self.P0_amp))

        # --- channel stages ---
        n_steps = []
        i_ase = 0
        for st, cc in zip(spec.stages, self.plan):
            if cc["kind"] == "fiber":
                field, steps = self._fiber(field, st, cc)
                n_steps.append(steps)
                continue
            if "sigma_ase" in cc:
                if field.ndim == 1:  # physical 2-pol ASE
                    field = torch.stack([field, torch.zeros_like(field)])
                field = field * float(f32(cc["sqrtG"]))
                d = gaussian((4, n), cc["sigma_ase"], gen,
                             draw("ase", i_ase))
                i_ase += 1
                field = field + torch.complex(d[:2], d[2:])
            else:
                field = field * float(f32(cc["sqrtG"]))

        # --- PD (reference devices.py:1378-1555) ---
        P = field.real ** 2 + field.imag ** 2
        if field.ndim == 2:
            P = P.sum(dim=0)
        i_ph = P * float(f32(spec.pd_r))
        i = i_ph
        if spec.include_thermal or spec.include_shot:
            # the reference folds i_dark into the noise track
            i = i + float(f32(spec.i_dark))
        if spec.include_thermal:
            i = i + gaussian((n,), self.S_T ** 0.5, gen, draw("thermal"))
        if spec.include_shot:
            S_N = ((i_ph.mean() + float(f32(spec.i_dark)))
                   * float(2 * f32(e)) * float(f32(self.params.fs / 2)))
            i = i + gaussian((n,), torch.sqrt(S_N), gen, draw("shot"))

        # --- electrical LPF (zero-phase |H|^2) and slot sampling ---
        v = filters.apply_freq_response(i * float(f32(spec.pd_R_load)),
                                        self.H2_pd).contiguous()
        return v, v[self.instant::sps], tuple(n_steps)

    def _fiber(self, f, st: FiberSpec, cc: dict):
        """One span: a fixed step schedule, or phi_max-adaptive steps."""
        phi_w = getattr(self, cc["phi_name"])
        if cc["hs"] is not None:
            return ssfm.ssfm_scan_inside(f, phi_w, cc["hs"], st.gamma,
                                         cc["a_km"]), len(cc["hs"])
        with np.errstate(divide="ignore"):
            h0 = min(f32(st.phi_max)
                     / (abs(f32(st.gamma)) * ssfm.max_power(f)),
                     f32(st.length))
        return ssfm.ssfm_while_inside(f, phi_w, st.length, st.gamma,
                                      st.phi_max, h0, cc["a_km"],
                                      adaptive=True)

    # ---- host conveniences ----
    def _bits(self, bits, prbs_order: int):
        if bits is None:
            bits = prbs(prbs_order, length=self.n_bits)[0]
        bits = np.asarray(bits).reshape(-1)
        if bits.size != self.n_bits:
            raise ValueError(f"need {self.n_bits} bits, got {bits.size}")
        return bits.astype(np.uint8), torch.as_tensor(
            bits.astype(np.float32), device=self.device)

    @torch.no_grad()
    def run(self, bits=None, seed: int = 0, prbs_order: int = 9,
            noise: Optional[dict] = None):
        """Run the chain on ``bits`` (default: a PRBS of ``prbs_order``).
        Returns a namespace with ``tx`` (uint8 bits), ``v`` and ``slots``
        (tensors on the device) and ``n_steps``."""
        tx, bits_f32 = self._bits(bits, prbs_order)
        v, slots, n_steps = self(bits_f32, seed=seed, noise=noise)
        return SimpleNamespace(tx=tx, v=v, slots=slots, n_steps=n_steps)

    @torch.no_grad()
    def dsp(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = 128,
            noise: Optional[dict] = None):
        """Chain -> GET_EYE -> THRESHOLD_EST -> slicer -> BER, with every
        receiver stage a reduction on the device and only scalars read back
        (mirrors ``models.ook.DSP`` + ``BER_analizer('counter')``).
        Returns a namespace with ``ber``, ``n_errors``, ``threshold``,
        ``eye`` (an :class:`Eye` without traces), ``tx`` and ``n_steps``."""
        tx, bits_f32 = self._bits(bits, prbs_order)
        v, slots, n_steps = self(bits_f32, seed=seed, noise=noise)
        m, rth, n_err = _ook_rx_ingraph(v, slots, bits_f32, self.params.sps,
                                        nslots, sps_resamp)
        out = {k: ((val.item() if val.ndim == 0 else val.cpu().numpy())
                   if isinstance(val, torch.Tensor) else val)
               for k, val in m.items()}
        for k in ("threshold", "y_left", "y_right"):
            if out.get(k) is not None and np.isnan(out[k]):
                out[k] = None
        out["dt"] = 1.0 / self.params.fs
        n_err = int(n_err.item())
        return SimpleNamespace(ber=n_err / self.n_bits, n_errors=n_err,
                               threshold=float(rth.item()), eye=Eye(out),
                               tx=tx, n_steps=n_steps)


def build_link(spec: LinkSpec, n_bits: int, params: SimParams, *,
               device) -> LinkProgram:
    """Build the link described by ``spec`` for ``n_bits`` slots at
    ``params`` on ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"``...).  A
    CUDA device with no card present raises: there is no CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"build_link(device={str(device)!r}): no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    return LinkProgram(spec, n_bits, params, device)
