"""The least work of one call, counted from the configuration's shapes and
the step counts the call returned, never from the kernels that happen to
run, and the published peaks of one NVIDIA H100 SXM it is held to.

Counting rules:

* FFTs: one read and one write of the field (8 B a complex64 sample, times
  the polarisations) for each transform the scheme needs, and
  ``5 n log2 n`` float32 operations.  The reference scheme needs one
  forward and one inverse transform a step; the fixed-step 4th-order
  (Yoshida) scheme three pairs a step; the step-doubling schemes 9 pairs
  (o4) or 3 pairs (local error) an attempt.  The kicks and spectral
  multiplies of a step are not counted: they could ride inside the
  transforms' passes.
* A dispersive medium, an optical band-pass and an EDFA's output filter:
  one transform pair each.
* Every other stage: one read of its input and one write of its output
  (bits and voltages float32, fields complex64, unit draws float32).
* The receiver: what the entry driver's ``receiver_bytes`` counts.

Stages are the configuration's ``spec`` entries, named as the program's
stage classes (``FiberSpec``, ``DBPSpec``, ``EDFASpec``, ``DMSpec``,
``BPFSpec``, ``RepeatSpec``); another name is refused.
* Least time: the larger of bytes / HBM bandwidth and operations / float32
  peak.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
FP32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
F32, C64 = 4, 8


def _fft_per_step(st: dict) -> int:
    if st["h"] is not None:
        return 6 if st["method"] == "o4" else 2
    return {"reference": 2, "o4": 18, "local_error": 6}[st["method"]]


def _noisy_edfa(st: dict) -> bool:
    return st["spec"] == "EDFASpec" and st.get("NF") is not None


def _stages(cfg: dict):
    """``(stage, polarisations in, polarisations out)`` of each stage in
    run order, repeats unrolled (a block with a noisy EDFA takes a
    two-polarisation field from its first span on)."""
    pols = 1
    for st in cfg["link"]["stages"]:
        subs = [st]
        if st["spec"] == "RepeatSpec":
            pols = 2 if any(map(_noisy_edfa, st["stages"])) else pols
            subs = st["stages"] * st["n"]
        for s in subs:
            out = 2 if _noisy_edfa(s) else pols
            yield s, pols, out
            pols = out


def channel_work(cfg: dict, n: int, n_bits: int, rx_bytes: int,
                 n_steps) -> tuple:
    """``(bytes, flops)`` of one channel through the link and the
    receiver, ``rx_bytes`` the receiver's and ``n_steps`` the step counts
    of its fiber stages."""
    link = cfg["link"]
    by, fl = 0.0, 0.0
    fft_by, fft_fl = 2 * C64 * n, 5 * n * math.log2(n)  # one transform
    # DAC: bits in, drive out; laser: draws in, field out; MZM: drive
    # (and the laser's field) in, field out
    laser = bool(link.get("lw")) + (link.get("rin") is not None)
    by += n_bits * F32 + n * F32
    if laser:
        by += laser * n * F32 + n * C64
    by += n * F32 + bool(laser) * n * C64 + n * C64
    steps = iter(n_steps)
    pols = 1
    for st, pols_in, pols in _stages(cfg):
        kind = st["spec"]
        if kind in ("FiberSpec", "DBPSpec"):
            k = _fft_per_step(st) * next(steps)
        elif kind in ("DMSpec", "BPFSpec"):
            k = 2
        elif kind == "EDFASpec":
            k = 2 * (st.get("BW") is not None)
            by += (pols_in * n * C64 + _noisy_edfa(st) * 4 * n * F32
                   + pols * n * C64)
        else:
            raise ValueError(f"no work count for stage {kind!r}")
        by += k * fft_by * pols
        fl += k * fft_fl * pols
    # photodiode: field and draws in, current out; LPF; ADC
    by += (pols * n * C64
           + (link["include_thermal"] + link["include_shot"]) * n * F32
           + n * F32)
    by += 2 * n * F32
    if link["adc_bits"] is not None:
        by += 2 * n * F32
    return by + rx_bytes, fl


def least_time_s(by: float, fl: float) -> float:
    return max(by / HBM_BYTES_PER_S, fl / FP32_FLOPS)
