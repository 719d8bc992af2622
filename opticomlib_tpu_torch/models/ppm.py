"""M-ary Pulse Position Modulation encode/decode, decision and BER analysis
(port of ``opticomlib_tpu.models.ppm``; parity with reference
opticomlib/ppm.py, file:line cited per function).

The decision functions on tensors (:func:`sdd_positions`,
:func:`hdd_positions`, :func:`positions_to_bits`) are what the fused
receivers of ``link.LinkProgram`` run on the device; the rest is the host
side over the port's signals and devices.  The only randomness (HDD symbol
repair) uses host NumPy like the reference, with an optional ``rng``.
"""
from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch
from scipy.constants import pi
from scipy.integrate import quad

from ..devices import GET_EYE, SAMPLER
from ..eyediag import Eye
from ..params import gv
from ..rng import KeyLike, resolve
from ..signals import Array_Like, BinarySequence, ElectricalSignal
from ..utils.analysis import Q, dec2bin_array, str2array, tic, toc

__all__ = ["PPM_ENCODER", "PPM_DECODER", "HDD", "SDD", "THRESHOLD_EST",
           "DSP", "BER_analizer", "theory_BER",
           "sdd_positions", "hdd_positions", "positions_to_bits",
           "sdd_positions_jax", "hdd_positions_jax", "positions_to_bits_jax"]


# ---------------------------------------------------------------------------
# Decision functions on tensors (used by link.LinkProgram.dsp_ppm)
# ---------------------------------------------------------------------------
def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``'s
    rule; ``torch.argmax`` does not promise which of equal maxima it
    returns)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    top = x == x.max(dim=-1, keepdim=True).values
    return torch.where(top, idx, x.shape[-1]).min(dim=-1).values


def sdd_positions(slot_samples: torch.Tensor, M: int) -> torch.Tensor:
    """Soft decision on the device: per-symbol argmax of the
    1-sample-per-slot waveform, the first slot on a tie (twin of
    :func:`SDD`, reference ppm.py:248-253).  Returns ``(n_sym,)`` int32
    ON-slot positions."""
    x = slot_samples.real if slot_samples.is_complex() else slot_samples
    return _first_argmax(x.reshape(-1, M)).to(torch.int32)


def hdd_positions(on_slots: torch.Tensor, M: int,
                  uniform: torch.Tensor) -> torch.Tensor:
    """Hard-decision symbol repair on the device (twin of :func:`HDD`,
    reference ppm.py:184-190).  ``uniform``: one draw in [0, 1) a slot,
    ``(n_sym, M)`` float32.

    One expression covers all three cases: score every slot with its draw
    plus 1 if the slicer called it ON, then take the per-symbol argmax: a
    symbol with several ON slots keeps a uniformly random one, a single-ON
    symbol keeps its slot, and a zero-ON symbol raises a uniformly random
    slot.  Returns ``(n_sym,)`` int32 positions."""
    on = on_slots.reshape(-1, M)
    score = uniform.reshape(on.shape).to(torch.float32) + on.to(torch.float32)
    return _first_argmax(score).to(torch.int32)


def positions_to_bits(positions: torch.Tensor, M: int) -> torch.Tensor:
    """ON-slot positions -> MSB-first information bits, uint8 (twin of
    :func:`PPM_DECODER` + ``dec2bin_array``, reference ppm.py:83-125)."""
    k = int(np.log2(M))
    shifts = torch.arange(k - 1, -1, -1, device=positions.device)
    return ((positions[:, None] >> shifts) & 1).reshape(-1).to(torch.uint8)


#: the JAX package's names of the decisions (``sdd_positions_jax`` and
#: ``positions_to_bits_jax`` take the same arguments)
sdd_positions_jax = sdd_positions
positions_to_bits_jax = positions_to_bits


def hdd_positions_jax(on_slots: torch.Tensor, M: int,
                      key: KeyLike) -> torch.Tensor:
    """:func:`hdd_positions` under the JAX package's name and arguments:
    the ``(n_sym, M)`` uniform scores are drawn from ``key`` (an int seed or
    a ``torch.Generator`` on ``on_slots``' device, the port's keys), as the
    JAX function draws them from its ``jax.random`` key.  Torch's Philox
    stream is not threefry: a symbol with one ON slot gives the JAX
    position, the random repairs agree in distribution only."""
    if key is None:
        raise TypeError("hdd_positions_jax needs a key (an int seed or a "
                        "torch.Generator)")
    n_sym = on_slots.numel() // M
    uniform = torch.rand((n_sym, M), generator=resolve(key, on_slots.device),
                         device=on_slots.device, dtype=torch.float32)
    return hdd_positions(on_slots, M, uniform)


def _as_bits(input) -> np.ndarray:
    if isinstance(input, BinarySequence):
        return input.data.astype(bool)
    if isinstance(input, str):
        s = input.replace(",", " ").replace(";", " ").strip()
        if " " not in s:
            s = " ".join(s)
        return str2array(s, bool)
    if isinstance(input, torch.Tensor):
        input = input.detach().cpu().numpy()
    if isinstance(input, Array_Like):
        return np.array(input, dtype=bool)
    raise TypeError(
        "`input` must be of type (str, list, tuple, ndarray, binary_sequence)")


def PPM_ENCODER(input, M: int) -> BinarySequence:
    """Group log2(M) bits -> decimal -> one-hot slot position within each
    M-slot symbol (vectorized, reference ppm.py:27-79)."""
    tic()
    bits = _as_bits(input)
    k = int(np.log2(M))
    bits = bits[: len(bits) // k * k]
    decimal = np.sum(bits.reshape(-1, k) * 2 ** np.arange(k)[::-1], axis=-1)
    ppm = np.zeros(decimal.size * M, dtype=bool)
    ppm[np.arange(decimal.size) * M + decimal] = 1
    out = BinarySequence(ppm)
    out.execution_time = toc()
    return out


def PPM_DECODER(input, M: int) -> BinarySequence:
    """ON-slot position mod M -> bits (vectorized dec2bin,
    reference ppm.py:83-125)."""
    tic()
    bits = _as_bits(input)
    k = int(np.log2(M))
    decimal = np.where(bits == 1)[0] % M
    out = BinarySequence(dec2bin_array(decimal, k).ravel())
    out.execution_time = toc()
    return out


def HDD(input, M: int, rng: Optional[np.random.Generator] = None
        ) -> BinarySequence:
    """Hard-decision symbol repair: symbols with zero ON slots get a random
    slot raised; symbols with multiple ON slots keep one at random
    (reference ppm.py:128-194)."""
    tic()
    bits = _as_bits(input)
    if not M & (M - 1) == 0:
        raise ValueError("`M` must be a power of 2.")
    if bits.size % M != 0:
        raise ValueError("The length of `input` must be a multiple of `M`.")
    rng = rng or np.random

    def _randint(n: int) -> int:
        return int(rng.integers(n)) if hasattr(rng, "integers") \
            else int(rng.randint(n))

    n_sym = bits.size // M
    s = np.sum(bits.reshape(n_sym, M), axis=-1)
    out = bits.copy()

    for i in np.where(s == 0)[0]:
        out[i * M + _randint(M)] = 1
    for i in np.where(s > 1)[0]:
        j = np.where(out[i * M:(i + 1) * M] == 1)[0]
        out[i * M:(i + 1) * M] = 0
        out[i * M + int(rng.choice(j))] = 1

    result = BinarySequence(out)
    result.execution_time = toc()
    return result


def SDD(input, M: int) -> BinarySequence:
    """Soft decision: subsample mid-slot, argmax within each M-slot symbol
    (reference ppm.py:198-257)."""
    tic()
    if not M & (M - 1) == 0:
        raise ValueError("`M` must be a power of 2.")

    if isinstance(input, ElectricalSignal):
        x = np.asarray(input.to_numpy()).real
    elif isinstance(input, torch.Tensor):
        x = input.detach().cpu().numpy().real
    elif isinstance(input, Array_Like):
        x = np.asarray(input)
    else:
        raise TypeError("`input` must be electrical_signal or array_like.")

    if x.size % (M * gv.sps) != 0:
        raise ValueError(
            "The length of `input` must be a multiple of `M*sps`.")

    sub = x[gv.sps // 2::gv.sps]
    i = np.argmax(sub.reshape(-1, M), axis=-1)
    out = np.zeros_like(sub, dtype=np.uint8)
    out[np.arange(i.shape[0]) * M + i] = 1

    result = BinarySequence(out)
    result.execution_time = toc()
    return result


def THRESHOLD_EST(eye_obj: Eye, M: int) -> float:
    """Optimal M-PPM hard-decision threshold: argmin of
    ``1 - Q((r-mu1)/s1)*(1-Q((r-mu0)/s0))**(M-1)`` (reference ppm.py:261-305)."""
    if not M & (M - 1) == 0:
        raise ValueError("`M` must be a power of 2.")
    if not isinstance(eye_obj, Eye):
        raise TypeError("`eye_obj` must be of type `eye`.")
    mu0, mu1 = eye_obj.mu0, eye_obj.mu1
    s0, s1 = eye_obj.s0, eye_obj.s1
    r = np.linspace(mu0, mu1, 1000)
    return float(r[np.argmin(
        1 - Q((r - mu1) / s1) * (1 - Q((r - mu0) / s0)) ** (M - 1))])


def DSP(input, M: int, decision: Literal["hard", "soft"] = "hard",
        threshold: Optional[float] = None) -> BinarySequence:
    """PPM receiver DSP (reference ppm.py:309-415).

    hard: GET_EYE -> threshold -> SAMPLER -> slicer -> HDD -> DECODER;
    soft: SDD -> DECODER.
    """
    tic()
    if not isinstance(input, (ElectricalSignal,) + Array_Like):
        raise TypeError(
            "`input` must be of type `electrical_signal` or `Array_Like`.")
    if not isinstance(input, ElectricalSignal):
        input = ElectricalSignal(input)
    if input.size < gv.sps:
        raise ValueError("`input` must have at least `sps` samples.")
    if not M & (M - 1) == 0:
        raise ValueError("`M` must be a power of 2.")

    x = input
    if decision.lower() == "hard":
        if threshold is not None:
            rth = threshold
        else:
            eye_obj = GET_EYE(x, nslots=8192)
            rth = (eye_obj.threshold if eye_obj.threshold is not None
                   else THRESHOLD_EST(eye_obj, M))
        y = SAMPLER(x, gv.sps // 2)
        output = y > rth
        simbols = HDD(output, M)
        output = PPM_DECODER(simbols, M)
    elif decision.lower() == "soft":
        simbols = SDD(x, M)
        output = PPM_DECODER(simbols, M)
    else:
        raise ValueError('`decision` must be "hard" or "soft"')

    output.execution_time = toc()
    return output


def BER_analizer(mode: Literal["counter", "estimator"], **kwargs) -> float:
    """BER by counting or estimation from eye statistics
    (reference ppm.py:419-508)."""
    if mode.lower() == "counter":
        Tx = kwargs.get("Tx")
        Rx = kwargs.get("Rx")
        if Tx is None or Rx is None:
            raise KeyError(
                "`Tx` and `Rx` are required arguments for `mode='counter'`.")
        if not isinstance(Rx, BinarySequence):
            Rx = BinarySequence(Rx)
        if not isinstance(Tx, BinarySequence):
            Tx = BinarySequence(Tx)
        Tx = Tx[:Rx.size]
        assert Tx.size == Rx.size, \
            "Error: `Tx` and `Rx` must have the same length."
        return float(np.sum(Tx.data != Rx.data) / Tx.size)

    if mode.lower() == "estimator":
        eye_obj = kwargs.get("eye_obj")
        M = kwargs.get("M")
        decision = kwargs.get("decision", "soft")
        if eye_obj is None or M is None:
            raise KeyError(
                "`eye_obj` and `M` are required arguments for "
                "`mode='estimator'`.")
        if not M & (M - 1) == 0:
            raise ValueError("`M` must be a power of 2.")
        decision = decision.lower()
        if decision not in ("hard", "soft"):
            raise ValueError("`decision` must be 'hard' or 'soft'.")

        I1, I0 = eye_obj.mu1, eye_obj.mu0
        s1, s0 = eye_obj.s1, eye_obj.s0
        um = THRESHOLD_EST(eye_obj, M)

        if decision == "hard":
            Pe_sym = 1 - Q((um - I1) / s1) * (1 - Q((um - I0) / s0)) ** (M - 1)
        else:
            Pe_sym = 1 - 1 / (2 * pi) ** 0.5 * quad(
                lambda x: (1 - Q((I1 - I0 + s1 * x) / s0)) ** (M - 1)
                * np.exp(-x**2 / 2), -np.inf, np.inf)[0]
        return float(M / 2 / (M - 1) * Pe_sym)

    raise ValueError("Invalid mode. Use `counter` or `estimator`.")


def theory_BER(mu1, s0, s1, M: int,
               decision: Literal["soft", "hard"] = "soft"):
    """Analytic M-PPM BER from slot statistics; symbol->bit conversion
    ``M/2/(M-1)`` (reference ppm.py:512-577)."""
    if not M & (M - 1) == 0:
        raise ValueError("`M` must be a power of 2.")

    if decision == "soft":
        fun = np.vectorize(
            lambda mu1, s0, s1, M: 1 - 1 / (2 * pi) ** 0.5 * quad(
                lambda x: (1 - Q((mu1 + s1 * x) / s0)) ** (M - 1)
                * np.exp(-x**2 / 2), -np.inf, np.inf)[0])
    elif decision == "hard":
        @np.vectorize
        def fun(mu1_, s0_, s1_, M_):
            r = np.linspace(0, mu1_, 1000)
            return np.min(1 - Q((r - mu1_) / s1_) * (1 - Q(r / s0_)) ** (M_ - 1))
    else:
        raise ValueError("`decision` must be `soft` or `hard`.")
    return fun(mu1, s0, s1, M) * 0.5 * M / (M - 1)
