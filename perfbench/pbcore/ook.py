"""The OOK receiver's answers, as the entries ``dsp`` and ``dsp_wdm``
return them, and how they are compared with the plain reference.

Numbers compared, one channel at a time:

* ``v_rel_l2``: ``||v - v_ref|| / ||v_ref||`` of the receiver's voltage
  (after the LPF, and the ADC where the configuration has one), the whole
  waveform;
* ``eye_rel``: the largest relative gap of the eye's ``mu0``, ``mu1``,
  ``s0``, ``s1``;
* ``threshold_rel``: the relative gap of the decision threshold;
* ``steps_diff``: the largest gap of a fiber stage's step count (exact);
* ``n_errors_diff``: the gap of the bit-error count (exact).
"""
from __future__ import annotations

import math

import torch

NAMES = ("v_rel_l2", "eye_rel", "threshold_rel", "steps_diff",
         "n_errors_diff")


def answer(n_errors, threshold, mu0, mu1, s0, s1, n_steps, ok) -> dict:
    """One channel's answers as host numbers; ``ok``: the program's own
    check of the call (its laser's RIN kept the power non-negative)."""
    return dict(n_errors=int(n_errors), threshold=float(threshold),
                mu0=float(mu0), mu1=float(mu1), s0=float(s0), s1=float(s1),
                n_steps=[int(k) for k in n_steps], ok=bool(ok))


def _rel(a, b):
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)


def readings(side: dict, v, ref: dict) -> dict:
    """The numbers of one channel: ``side`` the answers of the side under
    test, ``v`` its voltage (``None`` where none was produced), ``ref`` the
    reference's ``run``."""
    vr = ref["v"].to(torch.float64)
    if v is None or tuple(v.shape) != tuple(vr.shape):
        v_rel = math.inf
    else:
        v_rel = float(torch.linalg.vector_norm(v.to(vr) - vr)
                      / torch.linalg.vector_norm(vr))
    eye = max(_rel(side[k], ref[k]) for k in ("mu0", "mu1", "s0", "s1"))
    steps = (max(abs(a - b) for a, b in zip(side["n_steps"], ref["n_steps"]))
             if len(side["n_steps"]) == len(ref["n_steps"]) else math.inf)
    return dict(v_rel_l2=v_rel, eye_rel=eye,
                threshold_rel=_rel(side["threshold"], ref["threshold"]),
                steps_diff=steps,
                n_errors_diff=abs(side["n_errors"] - ref["n_errors"]))


def receiver_bytes(cfg: dict, traffic: dict, n: int, n_bits: int) -> int:
    """The least bytes of one channel's receiver: its eye window (the
    first ``nslots`` slots, an even number), the slot samples and the
    bits, each read once as float32."""
    eye = min(n_bits, int(traffic["nslots"])) // 2 * 2 * cfg["params"]["sps"]
    return 4 * (eye + 2 * n_bits)
