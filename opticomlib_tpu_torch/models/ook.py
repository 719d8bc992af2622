"""On-Off Keying receiver DSP and BER analysis (port of
``opticomlib_tpu.models.ook``; parity with reference opticomlib/ook.py,
file:line cited per function).  The eye metrology runs on the signal's
device; the threshold scan and the BER count run on the host, as in the
JAX package.  :func:`THRESHOLD_EST`, the slicer of :func:`DSP` and
:func:`BER_analizer` are ``rx.decide`` spans (attribute ``step``;
:mod:`opticomlib_tpu_torch.utils.profiling`, off by default)."""
from __future__ import annotations

from typing import Literal

import numpy as np

from ..devices import GET_EYE, LPF, SAMPLER
from ..eyediag import Eye
from ..params import gv
from ..signals import BinarySequence, ElectricalSignal
from ..utils.analysis import Q, tic, toc
from ..utils.profiling import span, spanned

__all__ = ["THRESHOLD_EST", "DSP", "BER_analizer", "theory_BER"]


@spanned("rx.decide", step="threshold")
def THRESHOLD_EST(eye_obj: Eye) -> float:
    """Optimal OOK decision threshold from eye statistics: argmin of
    ``0.5*[Q((mu1-r)/s1) + Q((r-mu0)/s0)]`` over 1000 candidate levels
    (reference ook.py:22-60)."""
    mu0, mu1 = eye_obj.mu0, eye_obj.mu1
    s0, s1 = eye_obj.s0, eye_obj.s1
    r = np.linspace(mu0, mu1, 1000)
    return float(r[np.argmin(0.5 * (Q((mu1 - r) / s1) + Q((r - mu0) / s0)))])


def DSP(input: ElectricalSignal, BW: float = None):
    """OOK receiver DSP: [LPF] -> GET_EYE -> threshold -> SAMPLER -> slicer
    (reference ook.py:63-132).  Returns (bits, eye_obj, threshold)."""
    tic()
    x = LPF(input, BW) if BW is not None else input

    eye_obj = GET_EYE(x, nslots=8192, sps_resamp=128)
    rth = THRESHOLD_EST(eye_obj)

    x = SAMPLER(x, gv.sps // 2)  # one sample per bit
    with span("rx.decide", step="slicer"):
        output = x > rth  # a host BinarySequence
    output.execution_time = toc()
    return output, eye_obj, rth


@spanned("rx.decide", step="ber")
def BER_analizer(mode: Literal["counter", "estimator"], **kargs) -> float:
    """BER by error counting (Tx vs Rx) or estimation from eye statistics
    (reference ook.py:135-218)."""
    if mode == "counter":
        assert "Rx" in kargs and "Tx" in kargs, \
            "`Tx` and `Rx` are required arguments for `mode='counter'`."
        Rx, Tx = kargs["Rx"], kargs["Tx"]
        if not isinstance(Rx, BinarySequence):
            Rx = BinarySequence(Rx)
        if not isinstance(Tx, BinarySequence):
            Tx = BinarySequence(Tx)
        Tx = Tx[:Rx.size]
        assert Tx.size == Rx.size, \
            "Error: `Tx` and `Rx` must have the same length."
        return float(np.sum(Tx.data != Rx.data) / Tx.size)

    if mode == "estimator":
        assert "eye_obj" in kargs, \
            "`eye_obj` is a required argument for `mode='estimator'`."
        eye_obj = kargs["eye_obj"]
        I1, I0 = eye_obj.mu1, eye_obj.mu0
        s1, s0 = eye_obj.s1, eye_obj.s0
        um = THRESHOLD_EST(eye_obj)
        return float(0.5 * (Q((I1 - um) / s1) + Q((um - I0) / s0)))

    raise TypeError("Invalid mode. Use `counter` or `estimator`.")


def theory_BER(mu1, s0, s1):
    """Minimum-over-threshold analytic OOK BER given (mu1, s0, s1),
    vectorized (reference ook.py:222-257)."""

    @np.vectorize
    def fun(mu1_, s0_, s1_):
        r = np.linspace(0, mu1_, 1000)
        return 0.5 * np.min(Q((mu1_ - r) / s1_) + Q(r / s0_))

    return fun(mu1, s0, s1)
