"""Split-step Fourier NLSE propagation.

Port of ``opticomlib_tpu.ops.ssfm``.  The reference scheme: symmetric
NL-L-NL steps with the nonlinear operator frozen at the step start, and the
step size adapted to a maximum nonlinear phase rotation (Sinkin et al.
2003; reference devices.py:1038-1206).  One step is

    B, H = nl_halfstep(A, gamma*h/2)          # Triton kernel
    A    = ifft(cmul(fft(B), E(h))) ; A = cmul(A, H)   # cuFFT + Triton

with ``E(h) = exp(-alpha*h/2) * exp(i*phi(w)*h)``.

The higher-order schemes build on the true Strang step, whose second kick
reads the field after the linear substep: the fixed-step 4th-order Yoshida
composition (``ssfm_o4_scan_inside``) and the two step-doubling local-error
schemes (``ssfm_o4_auto_inside``, ``ssfm_local_error_inside``).  Each kick
is one ``nl_halfstep`` launch and each spectral multiply one ``cmul``; the
two kicks of a substep stay two rotations, as in the JAX package.

On a card the phi_max-adaptive loop takes a fused step instead, where the
field is a contiguous complex64 CUDA tensor and no ``linear_step`` is hung
on (:data:`STEP_COUNTS`):

    B, H = nl_halfstep(A, gamma*h/2)
    X = fft(B) ; spectral_phase(X)             # E(h) built in registers
    A, m = cmul_max(ifft(X, norm="forward"), H)   # and max|A|^2, one pass

``spectral_phase`` folds the inverse's 1/n into ``E`` at a power-of-two
length (otherwise the inverse keeps its own 1/n), and ``cmul_max`` gives
the ``max|A|^2`` that sets the next step, so a step is five launches and
writes no factor and no power temporary.  The fused step is bit-equal to
the composed one: the same factor and product roundings, a power-of-two
scale commutes with every rounding of the transform, and a maximum is
order-free.  Every other caller takes the composed step: the CPU, other
dtypes, a ``linear_step`` (the sharded solver's transforms), the
fixed-step and higher-order schemes.  ``STEP_COUNTS`` counts the loop's
steps by path; the kernels count in ``kernels.LAUNCHES`` (``power_max``,
the first step size's one-read maximum, as ``cmul_max``); the link's
``fiber`` span says ``fused``.

The fixed-step 4th-order scan fuses on the same fields (with no
``spectral`` hook): its substeps run as one chain, a leading kick and then
per substep

    X = fft(A) ; cmul(X, E, out=X)
    A = ifft(X, norm="forward") ; strang_kicks(A, 1/n, c_k, c_k+1)

``strang_kicks`` applies the inverse's 1/n (at a power-of-two length; the
inverse keeps it otherwise), the substep's trailing kick and the next
substep's leading kick in one pass, and writes no rotation: 13 pointwise
passes a 4-step span in place of 24 kicks and 12 scaling passes, bit-equal
to the composed scan (the kicks round as ``nl_halfstep`` launches do).
:data:`O4_COUNTS` counts the scan's steps by path.

Step control runs in float32 on the host, as the JAX loops run it in
float32 on the device: ``z``, ``h`` and the next ``h`` are ``np.float32``
so the step counts match the JAX package's.  The adaptive loops read back
once per step (``max|A|^2``, or the two error norms of a step-doubling
attempt): the read-back decides ``h`` and termination.

The ``*_inside`` loops take the hooks the sharded solver
(:mod:`opticomlib_tpu_torch.parallel.fiber`) hangs on: ``reduce_max`` /
``reduce_sum`` (a collective applied to the device scalar *before* it is
read back, so every rank reads the same float32 and takes the same steps),
``linear_step`` / ``spectral`` (the linear substep through a distributed
transform) and ``h_max`` (a cap on the adaptive step).  With no hook given a
loop computes what it computed without them, bit for bit.

The staged wrappers (:func:`ssfm_propagate`, :func:`ssfm_scan_o4`,
:func:`ssfm_o4_auto`, :func:`ssfm_local_error`; what ``devices.FIBER``
runs) take a complex field tensor and the angular-frequency axis, and
return ``(A, n_steps)``: the complex64 field on ``A``'s device and the
number of steps taken (attempted, for the step-doubling schemes).
``ssfm_propagate(return_steps=True)`` returns the trajectory instead.

Progress: the reference loops tick the progress handler once a step, and
a tick is a no-op while none is installed; :class:`progress_bar` installs
a tqdm bar as the handler (``FIBER(show_progress=True)``).  The loops
already run on the host, so a tick reads the host's ``z`` and adds no
device sync.  (The JAX loops take a ``progress`` flag instead, because
their tick is a callback compiled into the program.)
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels

__all__ = ["linear_operator", "dispersion_phase", "alpha_per_km",
           "adaptive_h0", "dispersive_step", "progress_bar",
           "ssfm_step_schedule", "max_power", "STEP_COUNTS", "O4_COUNTS",
           "ssfm_while_inside",
           "ssfm_scan_inside", "ssfm_o4_scan_inside", "ssfm_o4_auto_inside",
           "ssfm_local_error_inside", "ssfm_propagate", "ssfm_scan_o4",
           "ssfm_o4_auto", "ssfm_local_error"]

_LOG10E_X10 = 4.342944819032518  # 10*log10(e): dB/km -> 1/km divisor
_MAX_STEPS = 400_000  # runaway backstop, as in the JAX loop

f32 = np.float32

#: steps of :func:`ssfm_while_inside` by the path they took: ``fused`` (the
#: card's two fused kernels around the inverse FFT) or ``composed``
STEP_COUNTS = {"fused": 0, "composed": 0}
#: steps of :func:`ssfm_o4_scan_inside` by the path they took: ``fused``
#: (the card's chain, one ``strang_kicks`` pass between transforms) or
#: ``composed``
O4_COUNTS = {"fused": 0, "composed": 0}


# ----------------------------------------------------------------------
# progress reporting (reference devices.py:1164-1170 tqdm bar)
# ----------------------------------------------------------------------
_progress_handler = None


def _progress_tick(z, length) -> None:
    if _progress_handler is not None:
        _progress_handler(float(z), float(length))


class progress_bar:
    """Context manager installing a tqdm progress handler for the
    reference loops (used by ``FIBER(show_progress=True)``).
    ``tqdm`` is imported on entry."""

    def __enter__(self):
        global _progress_handler
        from tqdm import tqdm
        self._bar = tqdm(total=100.0, unit="%",
                         bar_format="{l_bar}{bar}| {n:.1f}/{total}% "
                                    "[{elapsed}, {postfix}]")
        self._bar.set_postfix(step=0)
        self._n = 0

        def update(z, length):
            self._n += 1
            pct = min(100.0, 100.0 * z / max(length, 1e-30))
            self._bar.n = round(pct, 1)
            self._bar.set_postfix(step=self._n)
            self._bar.refresh()

        _progress_handler = update
        return self

    def __exit__(self, *exc):
        global _progress_handler
        _progress_handler = None
        self._bar.n = self._bar.total
        self._bar.refresh()
        self._bar.close()
        return False


def linear_operator(w_rad_s: np.ndarray, alpha_db_km: float, beta2: float,
                    beta3: float) -> np.ndarray:
    """Frequency-domain linear operator ``D(w) = -alpha/2 + i*beta2/2*w^2 +
    i*beta3/6*w^3`` [1/km], natural FFT order, complex64 (w in rad/ps, alpha
    in 1/km from dB/km; reference devices.py:1137-1145)."""
    w = np.asarray(w_rad_s, dtype=np.float64) * 1e-12  # rad/ps
    alpha = alpha_db_km / _LOG10E_X10
    D = -alpha / 2 + 1j * beta2 / 2 * w**2 + 1j * beta3 / 6 * w**3
    return D.astype(np.complex64)


def dispersion_phase(w_rad_s: np.ndarray, beta2: float,
                     beta3: float) -> np.ndarray:
    """Real dispersion phase rate ``phi(w) = beta2/2*w^2 + beta3/6*w^3``
    [rad/km], w in rad/ps, natural FFT order (float32)."""
    w = np.asarray(w_rad_s, dtype=np.float64) * 1e-12  # rad/ps
    phi = beta2 / 2 * w**2 + beta3 / 6 * w**3
    return phi.astype(np.float32)


def alpha_per_km(alpha_db_km: float) -> float:
    """Attenuation coefficient 1/km from dB/km (reference devices.py:1137)."""
    return float(alpha_db_km) / _LOG10E_X10


def adaptive_h0(phi_max: float, gamma: float, maxP: float,
                length: float) -> float:
    """Initial adaptive step ``phi_max / (|gamma|·maxP)`` capped at the span
    length; a dark input (``maxP == 0``) gives the full span in one step."""
    denom = abs(gamma) * maxP
    if denom == 0:
        return float(length)
    return min(phi_max / denom, float(length))


def ssfm_step_schedule(length: float, h: float) -> np.ndarray:
    """Fixed step schedule: ``h``-sized steps plus a final remainder
    (reference ``min(h, length - z)`` clipping, devices.py:1196)."""
    n_full = int(math.floor(length / h + 1e-9))
    rem = length - n_full * h
    hs = [h] * n_full
    if rem > 1e-9 * max(length, 1.0):
        hs.append(rem)
    if not hs:
        hs = [length]
    return np.asarray(hs, dtype=np.float32)


def _phi_step(phi_max, gamma, p):
    """The phi_max rule's step ``phi_max / (|gamma| p)`` in float32, ``p``
    the field's ``max|A|^2``: a float32 scalar, or an array of one a
    channel.  A dark field (``p = 0``) gives ``inf``: a loop calls it under
    ``np.errstate(divide="ignore")``, entered once, not once a step."""
    return f32(phi_max) / (abs(f32(gamma)) * p)


def _first_step(phi_max, gamma, p, length):
    """The first phi_max-adaptive step: :func:`_phi_step` capped at the
    span ``length`` (a dark field takes the whole span), float32."""
    with np.errstate(divide="ignore"):
        return np.minimum(_phi_step(phi_max, gamma, p), f32(length))


def _next_step(h_next, length, z, h_max=None):
    """The step after one that ended at ``z``: ``h_next`` (what the rule
    asks for; float32 scalars, or arrays of one a channel) capped at
    ``h_max`` where given and at what is left of the span, and no shorter
    than ``length * 1.5e-7``, below which the float32 ``z + h`` stalls."""
    if h_max is not None:
        h_next = np.minimum(h_next, f32(h_max))
    return np.maximum(np.minimum(h_next, length - z),
                      length * f32(1.5e-7))


def _step_loss(alpha: np.float32, h: np.float32) -> np.float32:
    """The step's field loss ``exp(-alpha/2*h)`` in float32."""
    return np.exp(f32(-0.5) * alpha * h, dtype=np.float32)


def _lin_factor(phi_w: torch.Tensor, alpha: np.float32,
                h: np.float32) -> torch.Tensor:
    """Linear-step multiplier ``exp(-alpha/2*h) * exp(i*phi_w*h)``."""
    th = phi_w * float(h)
    return torch.polar(torch.full_like(th, float(_step_loss(alpha, h))), th)


def _nl_l_nl_step(A: torch.Tensor, phi_w: torch.Tensor, alpha: np.float32,
                  h: np.float32, gamma: np.float32,
                  E: torch.Tensor = None, spectral=None) -> torch.Tensor:
    """One symmetric NL-L-NL split step (nonlinear operator frozen at the
    step start).  Pass a precomputed linear factor ``E`` when ``h`` is
    loop-constant; ``spectral``: see :func:`_strang_step`."""
    B, H = kernels.nl_halfstep(A, gamma * (h / f32(2)))
    if E is None:
        E = _lin_factor(phi_w, alpha, h)
    if spectral is None:
        A = torch.fft.ifft(kernels.cmul(torch.fft.fft(B, dim=-1), E), dim=-1)
    else:
        A = spectral(B, E)
    return kernels.cmul(A, H)


def _fuses(A: torch.Tensor) -> bool:
    """True where the card's fused kernels take ``A``: a contiguous
    complex64 CUDA tensor."""
    return A.is_cuda and A.dtype == torch.complex64 and A.is_contiguous()


def _read_max(m: torch.Tensor, reduce_max=None) -> np.float32:
    if reduce_max is not None:
        m = reduce_max(m)
    return f32(m.item())


def max_power(A: torch.Tensor, reduce_max=None) -> np.float32:
    """``max|A|^2`` read back to the host (the per-step sync); one pass of
    ``kernels.power_max`` where the fused kernels take ``A``.
    ``reduce_max``: a collective applied to the 0-d device value before the
    read-back (the all-reduce(max) of a sharded waveform)."""
    return _read_max(kernels.power_max(A) if _fuses(A)
                     else kernels.power_max_ref(A), reduce_max)


def _fused_step(A: torch.Tensor, phi_w: torch.Tensor, alpha: np.float32,
                h: np.float32, gamma: np.float32, norm: str,
                m: torch.Tensor) -> tuple:
    """One :func:`_nl_l_nl_step` through the card's fused kernels; ``norm``
    the inverse FFT's (``"forward"`` where ``spectral_phase`` folds its
    1/n).  Returns ``(A, m)``, ``m`` holding ``max|A|^2``."""
    B, H = kernels.nl_halfstep(A, gamma * (h / f32(2)))
    X = kernels.spectral_phase(torch.fft.fft(B, dim=-1), phi_w,
                               _step_loss(alpha, h), h)
    Y = torch.fft.ifft(X, dim=-1, norm=norm)
    return kernels.cmul_max(Y, H, out=Y, m=m)


def ssfm_while_inside(A: torch.Tensor, phi_w: torch.Tensor, length, gamma,
                      phi_max, h0, alpha, adaptive: bool, reduce_max=None,
                      linear_step=None, h_max=None):
    """phi_max-adaptive (``adaptive=True``) or fixed-``h0`` split-step
    propagation over ``length`` km of ``A`` (complex64, last axis = time).

    ``reduce_max``: collective applied to the local ``max|A|^2`` (see
    :func:`max_power`).  ``linear_step``: ``(A, h) -> A`` in place of the
    single-FFT linear substep (the pencil or overlap-save transform of the
    sharded solver; ``phi_w`` may then be ``None``).  ``h_max``: a hard cap
    on the adaptive step (the overlap-save solver caps ``h`` at the size its
    halo was derived for).  Takes the fused step (module docstring) where
    ``A`` is a contiguous complex64 CUDA tensor, ``phi_w`` contiguous
    float32 and ``linear_step`` None, the composed step otherwise, and
    counts each step in :data:`STEP_COUNTS`.  Ticks the progress handler
    after each step.  Returns ``(A, n_steps)``."""
    alpha, length, gamma = f32(alpha), f32(length), f32(gamma)
    phi_max, h0 = f32(phi_max), f32(h0)
    z, h, steps = f32(0.0), min(h0, length), 0
    if h_max is not None:
        h = min(h, f32(h_max))
    fused = (linear_step is None and _fuses(A) and phi_w.is_contiguous()
             and phi_w.dtype == torch.float32)
    if fused:
        norm = ("forward" if kernels.spectral_scale(A.shape[-1]) != 1
                else "backward")
        m = torch.empty((), dtype=torch.float32, device=A.device)
    path = "fused" if fused else "composed"
    with np.errstate(divide="ignore"):
        while z < length and steps < _MAX_STEPS:
            z = z + h
            if fused:
                A, m = _fused_step(A, phi_w, alpha, h, gamma, norm, m)
            elif linear_step is None:
                A = _nl_l_nl_step(A, phi_w, alpha, h, gamma)
            else:  # the same frozen-operator step around another transform
                B, H = kernels.nl_halfstep(A, gamma * (h / f32(2)))
                A = kernels.cmul(linear_step(B, h), H)
            STEP_COUNTS[path] += 1
            if adaptive:
                h_next = _phi_step(phi_max, gamma, _read_max(m, reduce_max)
                                   if fused else max_power(A, reduce_max))
            else:
                h_next = h0
            h = _next_step(h_next, length, z, h_max)
            steps += 1
            _progress_tick(z, length)
    return A, steps


def ssfm_scan_inside(A: torch.Tensor, phi_w: torch.Tensor, hs, gamma,
                     alpha, spectral=None) -> torch.Tensor:
    """Fixed-schedule propagation over the float32 step sizes ``hs``.  The
    linear factor of the leading step size is built once; an off-schedule
    step (the final remainder) builds its own.  ``spectral``: see
    :func:`_strang_step`.  Ticks the progress handler after each step."""
    alpha, gamma = f32(alpha), f32(gamma)
    hs = np.asarray(hs, dtype=np.float32)
    E0 = _lin_factor(phi_w, alpha, hs[0])
    z, length = f32(0.0), hs.sum(dtype=np.float32)
    for h in hs:
        E = E0 if h == hs[0] else None
        A = _nl_l_nl_step(A, phi_w, alpha, h, gamma, E=E, spectral=spectral)
        z = z + h
        _progress_tick(z, length)
    return A


# ----------------------------------------------------------------------
# higher-order schemes (ops/ssfm.py:319-623 of the JAX package)
# ----------------------------------------------------------------------
# Yoshida (1990) triple jump: S4(h) = S2(w1 h) S2(w0 h) S2(w1 h), with
# w1 = 1/(2 - 2^(1/3)) and the negative midstep w0 = 1 - 2 w1.
_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_W0 = 1.0 - 2.0 * _W1


def _strang_step(A: torch.Tensor, phi_w: torch.Tensor, alpha: np.float32,
                 h: np.float32, gamma: np.float32,
                 E: torch.Tensor = None, spectral=None) -> torch.Tensor:
    """True Strang step: kick, linear substep, kick at the magnitudes after
    the linear substep (genuinely 2nd order), so neither kick reuses the
    other's rotation.  Pass ``E`` when it is precomputed for this ``h``.
    ``spectral``: ``(A, E) -> A`` in place of the single-FFT spectral
    multiply (the sharded solver's pencil transform)."""
    coeff = gamma * (h / f32(2))
    A = kernels.nl_halfstep(A, coeff)[0]
    if E is None:
        E = _lin_factor(phi_w, alpha, h)
    if spectral is None:
        A = torch.fft.ifft(kernels.cmul(torch.fft.fft(A, dim=-1), E), dim=-1)
    else:
        A = spectral(A, E)
    return kernels.nl_halfstep(A, coeff)[0]


def _o4_step(A, phi_w, alpha, h, gamma, E1=None, E0=None, spectral=None):
    """One 4th-order Yoshida step ``S4(h)``; ``E1``/``E0``: the linear
    factors of the ``w1 h`` and ``w0 h`` substeps when precomputed."""
    h1, h0 = h * f32(_W1), h * f32(_W0)
    A = _strang_step(A, phi_w, alpha, h1, gamma, E1, spectral)
    A = _strang_step(A, phi_w, alpha, h0, gamma, E0, spectral)
    return _strang_step(A, phi_w, alpha, h1, gamma, E1, spectral)


def _o4_chain(A, phi_w, alpha, hs, gamma, E1_0, E0_0) -> torch.Tensor:
    """The steps ``hs`` of :func:`ssfm_o4_scan_inside` as one chain of
    Strang substeps through the card's kernels (module docstring): a
    leading kick, then a transform pair and one ``strang_kicks`` pass a
    substep.  Bit-equal to the composed :func:`_o4_step` calls."""
    s = kernels.spectral_scale(A.shape[-1])
    norm = "forward" if s != 1 else "backward"
    coeffs = [gamma * (h * f32(w) / f32(2)) for h in hs
              for w in (_W1, _W0, _W1)]
    A = kernels.strang_kicks(A, 1.0, coeffs[0], out=torch.empty_like(A))
    k = 0
    for h in hs:
        E1, E0 = ((E1_0, E0_0) if h == hs[0] else
                  (_lin_factor(phi_w, alpha, h * f32(_W1)),
                   _lin_factor(phi_w, alpha, h * f32(_W0))))
        for E in (E1, E0, E1):
            X = torch.fft.fft(A, dim=-1)
            A = torch.fft.ifft(kernels.cmul(X, E, out=X), dim=-1, norm=norm)
            k += 1
            A = kernels.strang_kicks(A, s, coeffs[k - 1],
                                     coeffs[k] if k < len(coeffs) else None)
        O4_COUNTS["fused"] += 1
    return A


def ssfm_o4_scan_inside(A: torch.Tensor, phi_w: torch.Tensor, hs, gamma,
                        alpha, spectral=None) -> torch.Tensor:
    """Fixed-schedule 4th-order propagation over the float32 step sizes
    ``hs`` (3 Strang substeps, 3 FFT pairs and 6 kicks a step).  The two
    linear factors of the leading step size are built once.  ``spectral``:
    see :func:`_strang_step`.  Runs the card's chain (:func:`_o4_chain`)
    where ``A`` is a contiguous complex64 CUDA tensor and ``spectral`` is
    None, the composed steps otherwise, and counts each step in
    :data:`O4_COUNTS`."""
    alpha, gamma = f32(alpha), f32(gamma)
    hs = np.asarray(hs, dtype=np.float32)
    E1_0 = _lin_factor(phi_w, alpha, hs[0] * f32(_W1))
    E0_0 = _lin_factor(phi_w, alpha, hs[0] * f32(_W0))
    if spectral is None and _fuses(A):
        return _o4_chain(A, phi_w, alpha, hs, gamma, E1_0, E0_0)
    for h in hs:
        if h == hs[0]:
            A = _o4_step(A, phi_w, alpha, h, gamma, E1_0, E0_0, spectral)
        else:
            A = _o4_step(A, phi_w, alpha, h, gamma, spectral=spectral)
        O4_COUNTS["composed"] += 1
    return A


def _sq_norm(A: torch.Tensor) -> torch.Tensor:
    return (A.real**2 + A.imag**2).sum()


def _step_doubling_controller(A, length, h0, tol, attempt, rich_num,
                              rich_den, grow, reduce_sum=None):
    """Step-doubling local-error control shared by the self-tuning schemes
    (port of ``ops/ssfm.py:_step_doubling_controller``, saturation guard
    included).  ``attempt(A, h) -> (u_c, u_f)``: one coarse step and two
    fine half-steps; ``delta = ||u_f - u_c|| / ||u_f||`` decides:

      delta > 2 tol        -> discard, halve h
      tol < delta <= 2 tol -> accept (u_f, u_c Richardson-combined), h /= grow
      delta < tol/2        -> accept, h *= grow

    After ``max_rejects`` consecutive rejections that do not improve delta
    by 30 %, the estimate is declared saturated (tol below the float32
    floor): h is restored to where the plateau began and every later step
    is accepted at that size.  Each attempt reads the two norms back (one
    sync).  ``reduce_sum``: a collective applied to the two local squared
    norms, stacked in one tensor, before the read-back (one all-reduce an
    attempt makes the control global on a sharded waveform).  Returns
    ``(A, n_attempted_steps)``."""
    length, tol, grow = f32(length), f32(tol), f32(grow)
    rich_num, rich_den = float(f32(rich_num)), float(f32(rich_den))
    h_floor = length * f32(1.5e-7)
    max_rejects = 8
    restore = f32(2.0 ** max_rejects)
    improve_factor = f32(0.7)
    z, h, steps = f32(0.0), f32(h0), 0
    rejects, saturated, delta_prev = 0, False, f32(np.inf)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        while z < length and steps < _MAX_STEPS:
            h = min(h, length - z)
            u_c, u_f = attempt(A, h)
            norms = torch.stack([_sq_norm(u_f - u_c), _sq_norm(u_f)])
            if reduce_sum is not None:
                norms = reduce_sum(norms)
            err2, ref2 = norms.tolist()
            delta = np.sqrt(f32(err2)) / max(np.sqrt(f32(ref2)), f32(1e-30))
            trip = rejects >= max_rejects and not saturated
            accept = bool(delta <= f32(2) * tol or h <= h_floor
                          or saturated or trip)
            if accept:
                A = (u_f * rich_num - u_c) / rich_den
                z = z + h
            improving = delta < delta_prev * improve_factor
            rejects = 0 if accept else (1 if improving else rejects + 1)
            delta_prev = f32(np.inf) if accept else delta
            saturated = saturated or trip
            if not accept:
                h_next = h / f32(2)
            elif trip:
                h_next = h * restore            # undo the plateau halvings
            elif saturated:
                h_next = h                      # fixed-step mode
            elif delta > tol:
                h_next = h / grow
            elif delta < tol / f32(2):
                h_next = h * grow
            else:
                h_next = h
            h = f32(min(max(h_next, h_floor), length))
            steps += 1
    return A, steps


def ssfm_o4_auto_inside(A: torch.Tensor, phi_w: torch.Tensor, length, gamma,
                        tol, h0, alpha, reduce_sum=None, spectral=None):
    """Self-tuning 4th-order propagation: Yoshida S4 steps under
    step-doubling control (Richardson ``(16 u_f - u_c)/15``, growth
    ``2^(1/5)``; 9 FFT pairs an attempt).  ``reduce_sum``: see
    :func:`_step_doubling_controller`; ``spectral``: see
    :func:`_strang_step`.  Returns ``(A, n_attempts)``."""
    alpha, gamma = f32(alpha), f32(gamma)

    def s4(A, h):
        return _o4_step(A, phi_w, alpha, h, gamma, spectral=spectral)

    def attempt(A, h):
        half = h / f32(2)
        return s4(A, h), s4(s4(A, half), half)

    return _step_doubling_controller(A, length, h0, tol, attempt, 16.0, 15.0,
                                     2.0 ** (1.0 / 5.0), reduce_sum)


def ssfm_local_error_inside(A: torch.Tensor, phi_w: torch.Tensor, length,
                            gamma, tol, h0, alpha, reduce_sum=None,
                            spectral=None):
    """Sinkin et al. (2003) local-error method: Strang steps under
    step-doubling control (Richardson ``(4 u_f - u_c)/3``, growth
    ``2^(1/3)``; 3 FFT pairs an attempt).  ``reduce_sum`` and ``spectral``
    as for :func:`ssfm_o4_auto_inside`.  Returns ``(A, n_attempts)``."""
    alpha, gamma = f32(alpha), f32(gamma)

    def s2(A, h):
        return _strang_step(A, phi_w, alpha, h, gamma, spectral=spectral)

    def attempt(A, h):
        half = h / f32(2)
        return s2(A, h), s2(s2(A, half), half)

    return _step_doubling_controller(A, length, h0, tol, attempt, 4.0, 3.0,
                                     2.0 ** (1.0 / 3.0), reduce_sum)


# ----------------------------------------------------------------------
# staged wrappers (ops/ssfm.py:538-741 of the JAX package)
# ----------------------------------------------------------------------
def dispersive_step(A: torch.Tensor, D, h) -> torch.Tensor:
    """Pure linear step: ``ifft(fft(A) * exp(D*h))`` along the last axis,
    ``D`` the linear operator (:func:`linear_operator`; a NumPy array or a
    tensor) on ``A``'s device (reference devices.py:1027-1029 and 1156)."""
    D = torch.as_tensor(D, device=A.device)
    return torch.fft.ifft(torch.fft.fft(A, dim=-1) * torch.exp(D * h),
                          dim=-1)


def _prepare(A: torch.Tensor, w_rad_s, beta_2, beta_3):
    A = A.to(torch.complex64).contiguous()
    phi_w = torch.as_tensor(dispersion_phase(w_rad_s, beta_2, beta_3),
                            device=A.device)
    return A, phi_w


def ssfm_propagate(A: torch.Tensor, w_rad_s, length: float,
                   alpha: float = 0.0, beta_2: float = 0.0,
                   beta_3: float = 0.0, gamma: float = 0.0,
                   phi_max: float = 0.01, h=None, return_steps: bool = False):
    """Propagate the field ``A`` (complex, last axis = time) through
    ``length`` km of fiber with the reference scheme (reference
    devices.py:1038-1206): fixed steps of ``h``, or ``phi_max``-adaptive
    from the input's peak power, ticking the progress handler
    (:class:`progress_bar`) once a step.

    ``return_steps=True`` returns the trajectory ``(z, A_z)`` instead of
    ``(A, n_steps)`` (:func:`_ssfm_trajectory`): ``z`` a float64 NumPy
    array of the positions [km], from 0, and ``A_z`` the field at each,
    complex64 frames stacked on ``A``'s device.

    NOTE reference parity quirk (devices.py:1154-1160), kept: a
    dispersion-free span, or ``gamma == 0``, takes ONE full-span step when
    ``h`` is not given, even with ``gamma != 0`` and ``alpha != 0``."""
    A, phi_w = _prepare(A, w_rad_s, beta_2, beta_3)
    a_km = alpha_per_km(alpha)
    linear_only = (beta_2 == 0 and beta_3 == 0) or gamma == 0
    if return_steps:
        return _ssfm_trajectory(A, phi_w, a_km, length, gamma, phi_max, h,
                                linear_only)
    if h is not None or linear_only:
        hs = (ssfm_step_schedule(length, h) if h is not None
              else np.asarray([length], dtype=np.float32))
        return ssfm_scan_inside(A, phi_w, hs, gamma, a_km), len(hs)
    h0 = adaptive_h0(phi_max, gamma, float(max_power(A)), length)
    return ssfm_while_inside(A, phi_w, length, gamma, phi_max, h0, a_km,
                             adaptive=True)


def _max_power64(A: torch.Tensor) -> float:
    """``max(re^2 + im^2)`` of a complex64 field in float64 (what the JAX
    trajectory reads off its complex128 host frames)."""
    return float(torch.view_as_real(A).double().square().sum(-1).max())


def _ssfm_trajectory(A: torch.Tensor, phi_w: torch.Tensor, a_km, length,
                     gamma, phi_max, h, linear_only):
    """Host-stepped propagation that keeps every step's field: the
    trajectory of ``return_steps`` (reference devices.py:1149-1202; the JAX
    package's ``ops.ssfm._ssfm_trajectory``).

    The step grid is the JAX package's, in float64 on the host: the first
    step from :func:`adaptive_h0` on the input's peak power (float32, as
    JAX reads it off the complex64 input), each later one from
    ``adaptive_h0(..., inf)`` on the last frame's peak power (float64),
    every step clipped to what is left of the span; ``h`` given: fixed
    steps; ``linear_only``: one step.  Each step is one :func:`_nl_l_nl_step`
    (the ``nl_halfstep`` and ``cmul`` kernels on a card).  Returns ``(z,
    A_z)`` as :func:`ssfm_propagate` describes."""
    alpha, g = f32(a_km), f32(gamma)
    z, zs, frames = 0.0, [0.0], [A]
    if linear_only and h is None:
        h_ = float(length)
    elif h is None:
        h_ = adaptive_h0(phi_max, gamma, float(max_power(A)), length)
    else:
        h_ = min(float(h), length)
    while z < length:
        z += h_
        A = _nl_l_nl_step(A, phi_w, alpha, f32(h_), g)
        zs.append(z)
        frames.append(A)
        if h is None and not linear_only:
            h_ = adaptive_h0(phi_max, gamma, _max_power64(A), float("inf"))
        h_ = min(h_, length - z)
        if h_ <= 0:
            break
    return np.asarray(zs), torch.stack(frames)


def ssfm_scan_o4(A: torch.Tensor, w_rad_s, length: float, alpha=0.0,
                 beta_2=0.0, beta_3=0.0, gamma=0.0, h=1.0):
    """Fixed-step 4th-order (Yoshida) propagation over the schedule of
    ``h``-sized steps."""
    A, phi_w = _prepare(A, w_rad_s, beta_2, beta_3)
    hs = ssfm_step_schedule(length, h)
    return ssfm_o4_scan_inside(A, phi_w, hs, gamma,
                               alpha_per_km(alpha)), len(hs)


def ssfm_o4_auto(A: torch.Tensor, w_rad_s, length: float, alpha=0.0,
                 beta_2=0.0, beta_3=0.0, gamma=0.0, tol=1e-5, h0=None):
    """Self-tuning 4th-order propagation (step-doubling control to the
    relative local error ``tol`` a step; first step ``length/10``)."""
    A, phi_w = _prepare(A, w_rad_s, beta_2, beta_3)
    h0 = length / 10.0 if h0 is None else h0
    return ssfm_o4_auto_inside(A, phi_w, length, gamma, tol,
                               min(h0, length), alpha_per_km(alpha))


def ssfm_local_error(A: torch.Tensor, w_rad_s, length: float, alpha=0.0,
                     beta_2=0.0, beta_3=0.0, gamma=0.0, tol=1e-5, h0=None):
    """Sinkin local-error propagation (Strang steps under step-doubling
    control to ``tol``; first step ``length/10``)."""
    A, phi_w = _prepare(A, w_rad_s, beta_2, beta_3)
    h0 = length / 10.0 if h0 is None else h0
    return ssfm_local_error_inside(A, phi_w, length, gamma, tol,
                                   min(h0, length), alpha_per_km(alpha))
