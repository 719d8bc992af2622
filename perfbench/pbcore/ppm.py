"""The M-PPM cells' inputs and answers, as the entry ``dsp_ppm`` and the
plain reference of a PPM configuration both take them:

* the information bits of a call: the first ``n_sym * log2(M)`` bits of
  its row of the pool (the row holds one bit a slot, ``n_sym * M``);
* the HDD scores: one uniform draw in [0, 1) a slot, ``(n_sym, M)``
  float32, from a generator of their own seeded with a digest of those
  bits, made on the device that asks for them.  Both sides derive the
  same scores from the same bits, and no unit draw that enters the
  waveform is used for them;
* the numbers compared: the OOK receiver's five
  (:mod:`perfbench.pbcore.ook`) and ``repairs_diff``, the gap of the count
  of symbols the HDD repair decided (exact).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from perfbench.pbcore import ook

NAMES = ook.NAMES + ("repairs_diff",)


def info_bits(row, M: int) -> np.ndarray:
    """The information bits (uint8) of a pool row of ``n_sym * M`` bits."""
    row = np.asarray(row)
    n_sym = row.size // M
    return row[:n_sym * int(math.log2(M))].astype(np.uint8)


def hdd_scores(info: np.ndarray, M: int, device) -> torch.Tensor:
    """The ``(n_sym, M)`` uniform scores of the HDD repair of a call that
    carries the information bits ``info``, drawn on ``device``."""
    info = np.asarray(info, dtype=np.uint8)
    k = int(math.log2(M))
    digest = hashlib.blake2b(np.packbits(info).tobytes() + bytes([M]),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 2)
    return torch.rand((info.size // k, M), generator=gen, device=device,
                      dtype=torch.float32)


def answer(r, eye_graph: bool) -> dict:
    """One channel's answers, as host numbers, of a hard ``dsp_ppm``
    result ``r``; ``eye_graph``: whether the call's eye metrology replayed
    its CUDA graph."""
    n_repaired = getattr(r, "n_repaired", None)
    if n_repaired is None:
        raise RuntimeError("the program's dsp_ppm returns no n_repaired: "
                           "it cannot run this cell")
    e = r.eye
    out = ook.answer(r.n_errors, r.threshold, e.mu0, e.mu1, e.s0, e.s1,
                     r.n_steps, r.rin_ok)
    return dict(out, n_repaired=int(n_repaired), eye_graph=bool(eye_graph))


def readings(side: dict, v, ref: dict) -> dict:
    """:func:`perfbench.pbcore.ook.readings` and ``repairs_diff``."""
    return dict(ook.readings(side, v, ref),
                repairs_diff=abs(side["n_repaired"] - ref["n_repaired"]))


def receiver_bytes(cfg: dict, traffic: dict, n: int, n_bits: int) -> int:
    """The least bytes of one channel's hard receiver: its eye window (the
    first ``nslots`` slots, an even number) and the slot samples as
    float32, the information bits as bytes and the HDD scores as float32,
    each read once (``n_bits``: the slots)."""
    M = int(traffic["M"])
    eye = min(n_bits, int(traffic["nslots"])) // 2 * 2 * cfg["params"]["sps"]
    info = n_bits // M * int(math.log2(M))
    return 4 * (eye + n_bits) + info + 4 * n_bits
