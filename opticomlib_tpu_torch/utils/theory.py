"""Analytic receiver models: ASE power, slot voltages, noise variances,
optimum thresholds and closed-form BER for OOK / M-PPM PIN(+EDFA) receivers.

Copied from ``opticomlib_tpu.utils.theory`` (behavioral parity with
reference opticomlib/utils.py:1075-1493).  These are host-side NumPy
analytics (they run once per configuration, not per sample), used as
oracles for the simulated BER and for link budgeting.
"""
from __future__ import annotations

from typing import Literal, Optional

import numpy as np
from scipy.constants import c, e, h, k as kB, pi
from scipy.integrate import quad

from .analysis import Q, idb, idbm

__all__ = [
    "p_ase", "average_voltages", "noise_variances", "optimum_threshold",
    "theory_BER",
]


def p_ase(amplify: bool = True, wavelength: float = 1550e-9,
          G: Optional[float] = None, NF: Optional[float] = None,
          BW_opt: Optional[float] = None) -> float:
    """ASE noise power [W]: ``NF * h * f0 * (G-1) * BW_opt``
    (reference utils.py:1075-1114)."""
    if not amplify:
        return 0.0
    if G is None or NF is None or BW_opt is None:
        raise ValueError("`G`, `NF` and `BW_opt` must be specify.")
    return idb(NF) * h * (c / wavelength) * (idb(G) - 1) * BW_opt


def average_voltages(P_avg, modulation: Literal["ook", "ppm"], M=None,
                     ER=np.inf, amplify: bool = True, wavelength=1550e-9,
                     G=None, NF=None, BW_opt=None, r: float = 1.0,
                     R_L: float = 50.0):
    """Average ON/OFF slot voltages (+ ASE offset) of a PIN(+EDFA) receiver
    (reference utils.py:1116-1181).  Returns ``(mu[off,on], mu_ASE)``."""
    M = 2 if modulation.lower() == "ook" else M
    er = idb(ER)
    p_avg = idbm(P_avg)
    if amplify:
        if G is None:
            raise ValueError("G must be provided if amplify=True")
        g = idb(G)
    else:
        g = 1.0

    p_on = p_avg * M / (1 + (M - 1) / er)
    p_off = p_on / er

    mu_ase = r * p_ase(amplify, wavelength, G, NF, BW_opt) * R_L
    mu = r * g * np.array([p_off, p_on]) * R_L + mu_ase
    return mu, mu_ase


def noise_variances(P_avg, modulation: Literal["ook", "ppm"], M=None,
                    ER=np.inf, amplify: bool = True, wavelength=1550e-9,
                    G=None, NF=None, BW_opt=None, r: float = 1.0,
                    BW_el: float = 5e9, R_L: float = 50.0, T: float = 300.0,
                    NF_el: float = 0.0):
    """Per-slot noise variances [V^2]: thermal + shot + sig-ASE + ASE-ASE
    (reference utils.py:1183-1250).  Returns ``S[off, on]``."""
    mu, mu_ase = average_voltages(P_avg, modulation, M, ER, amplify,
                                  wavelength, G, NF, BW_opt, r, R_L)
    nf_el = idb(NF_el)
    if amplify:
        l = BW_el / BW_opt
        S_sig_ase = 2 * mu_ase * (mu - mu_ase) * l
        S_ase_ase = mu_ase**2 * (1 - l / 2) * l
    else:
        S_sig_ase = 0.0
        S_ase_ase = 0.0

    S_th = 4 * kB * T * BW_el * R_L
    S_sh = 2 * e * mu * BW_el * R_L
    return (S_th + S_sig_ase + S_ase_ase + S_sh) * nf_el


def optimum_threshold(mu0, mu1, S0, S1, modulation: Literal["ook", "ppm"],
                      M=None):
    """Closed-form optimum decision threshold for unequal Gaussian variances
    (reference utils.py:1252-1286)."""
    M = 2 if modulation.lower() == "ook" else M
    if S1 == S0:
        return (mu0 + mu1) / 2
    s1, s0 = S1**0.5, S0**0.5
    return (mu0 * S1 - mu1 * S0 + s1 * s0 * np.sqrt(
        (mu1 - mu0) ** 2 + 2 * (S1 - S0) * np.log(s1 / s0 * (M - 1))
    )) / (S1 - S0)


def theory_BER(P_avg, modulation: Literal["ook", "ppm"], M=None,
               decision=None, threshold=None, ER=np.inf,
               amplify: bool = False, f0: float = 193.4145e12, G=None,
               NF=None, BW_opt=None, r: float = 1.0, BW_el: float = 5e9,
               R_L: float = 50.0, T: float = 300.0, NF_el: float = 0.0):
    """Closed-form BER of a PIN(+EDFA) optical receiver for OOK / M-PPM
    (hard & soft decision), vectorized over ``P_avg``
    (reference utils.py:1288-1493)."""

    @np.vectorize(otypes=[np.float64])
    def _one(P_avg):
        if amplify:
            if G is None:
                raise ValueError('Enter the EDFA gain "G" in [dB].')
            if NF is None:
                raise ValueError('Enter the EDFA noise figure "NF" in [dB].')
            if BW_opt is None:
                raise ValueError(
                    'Enter the bandwidth of the optical filter "BW_opt" in [Hz].')
            g = idb(G)
            l = BW_el / BW_opt
            pase = idb(NF) * h * f0 * (g - 1) * BW_opt
            mu_ase = r * pase * R_L
        else:
            g, l, mu_ase = 1.0, 1.0, 0.0

        M_ = 2 if modulation.lower() == "ook" else M
        er = idb(ER)
        nf_el = idb(NF_el)
        p_avg = idbm(P_avg)

        p_on = p_avg * M_ / (1 + (M_ - 1) / er)
        p_off = p_on / er
        mu_on = r * g * p_on * R_L + mu_ase
        mu_off = r * g * p_off * R_L + mu_ase

        S_sig_ase = 2 * mu_ase * np.array(
            [mu_off - mu_ase, mu_on - mu_ase]) * l
        S_ase_ase = mu_ase**2 * (1 - l / 2) * l
        S_th = 4 * kB * T * BW_el * R_L * nf_el
        S_sh = 2 * e * np.array([mu_off, mu_on]) * BW_el * R_L
        s = np.sqrt(S_th + S_sig_ase + S_ase_ase + S_sh)

        if modulation.lower() == "ppm":
            if M_ is None:
                raise ValueError('Enter a value for "M".')
            if M_ < 2 or (M_ & (M_ - 1)):
                raise ValueError(
                    '"M" must be a power of 2 greater than or equal to 2.')
            if decision is None:
                raise ValueError('`decision` must be "hard" or "soft".')
            if decision.lower() == "hard":
                def SER(x):
                    return 1 - Q((x - mu_on) / s[1]) * (
                        1 - Q((x - mu_off) / s[0])) ** (M_ - 1)
                if threshold is not None:
                    if threshold <= 0 or threshold >= 1:
                        raise ValueError(
                            "The threshold value must be in the range (0, 1).")
                    ser = SER(threshold * mu_on + (1 - threshold) * mu_off)
                else:
                    ser = SER(np.linspace(mu_off, mu_on, 5000)).min()
            elif decision.lower() == "soft":
                ser = 1 - 1 / (2 * pi) ** 0.5 * quad(
                    lambda x: (1 - Q((mu_on - mu_off + s[1] * x) / s[0]))
                    ** (M_ - 1) * np.exp(-x**2 / 2), -np.inf, np.inf)[0]
            else:
                raise ValueError('decision must be "hard" or "soft"')
            return ser * M_ / 2 / (M_ - 1)

        if modulation.lower() == "ook":
            def BER(x):
                return 0.5 * (Q((mu_on - x) / s[1]) + Q((x - mu_off) / s[0]))
            if threshold is not None:
                if threshold <= 0 or threshold >= 1:
                    raise ValueError(
                        "The threshold value must be in the range (0, 1).")
                return BER(threshold * mu_on + (1 - threshold) * mu_off)
            return BER(np.linspace(mu_off, mu_on, 5000)).min()

        raise KeyError(f'The modulation type "{modulation}" is invalid.')

    return _one(P_avg)
