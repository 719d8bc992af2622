"""Pseudorandom binary sequence generation.

TPU-native re-design of the reference LFSR generator
(reference: opticomlib/devices.py:63-182, which runs a *per-bit Python while
loop*, devices.py:170-175).  Here we exploit the algebra of the generating
trinomial instead:

The reference's Galois-style update (output = LSB, feedback of taps
``(t1, t2)`` shifted into the LSB) makes the output stream satisfy the linear
recurrence over GF(2)::

    o[m] = o[m - d1] ^ o[m - d2],   d1 = order, d2 = tap2

(see derivation in the module tests).  Over GF(2) the square of a trinomial
is again a trinomial: ``(x^d1 + x^d2 + 1)^2 = x^(2 d1) + x^(2 d2) + 1``, so
the relation also holds at every power-of-two scale::

    o[m] = o[m - (2^k) d1] ^ o[m - (2^k) d2]    for all k >= 0.

Given ``L`` known outputs we can therefore produce ~``L`` new outputs in one
vectorized XOR (choose ``2^k`` so that ``2^k * d1 <= L``), doubling the
sequence per step: **O(log n) vector ops** instead of O(n) Python iterations.
This generates 2^26-bit PRBS streams in milliseconds on the host, and the
same construction runs as jnp ops when needed on-device.

Golden parity: first-20-bit vectors for all 7 supported orders match the
reference (reference tests/devices_test.py:55-69) — verified in
tests/test_prbs.py.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

__all__ = ["prbs", "PRBS_TAPS"]

# order -> (tap1, tap2) 1-indexed polynomial exponents
# (reference devices.py:134-142)
PRBS_TAPS = {
    7: (7, 6),
    9: (9, 5),
    11: (11, 9),
    15: (15, 14),
    20: (20, 3),
    23: (23, 18),
    31: (31, 28),
}


def _bootstrap(order: int, seed: int, n: int) -> Tuple[np.ndarray, int]:
    """Run the bit-serial LFSR for ``n`` steps (n is O(order), tiny)."""
    tap1, tap2 = PRBS_TAPS[order][0] - 1, PRBS_TAPS[order][1] - 1
    mask = (1 << order) - 1
    out = np.empty(n, dtype=np.uint8)
    lfsr = seed
    for i in range(n):
        out[i] = lfsr & 1
        new = ((lfsr >> tap1) ^ (lfsr >> tap2)) & 1
        lfsr = ((lfsr << 1) | new) & mask
    return out, lfsr


def prbs(order: int, length: Optional[int] = None,
         seed: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Generate a PRBS-``order`` bit stream.

    Parameters
    ----------
    order : {7, 9, 11, 15, 20, 23, 31}
        Degree of the generating trinomial.
    length : int, optional
        Number of output bits (default ``2**order - 1`` = one full period).
    seed : int, optional
        Initial LFSR state (default all-ones).  A zero (mod 2**order) seed is
        coerced to 1 with a warning, matching the reference
        (devices.py:145-151).

    Returns
    -------
    (bits, final_state) : (np.ndarray[uint8], int)
        The bit stream and the LFSR state after emitting ``length`` bits
        (usable as ``seed`` to continue the stream, reference
        devices.py:180-182).
    """
    if order not in PRBS_TAPS:
        raise ValueError(
            "The parameter `order` must be one of the following values "
            "(7, 9, 11, 15, 20, 23, 31).")
    if length is not None:
        if not isinstance(length, (int, np.integer)):
            raise TypeError("The parameter `len` must be an integer.")
        if length <= 0:
            raise ValueError(
                "The parameter `len` must be an integer greater than cero.")
    else:
        length = 2**order - 1
    length = int(length)

    seed = seed % (2**order) if seed is not None else (1 << order) - 1
    if seed == 0:
        seed = 1
        warnings.warn(
            "The seed can't be 0 or a multiple of 2**order. "
            "It has been changed to 1.", UserWarning)

    d1 = order
    d2 = PRBS_TAPS[order][1]  # o[m] = o[m-d1] ^ o[m-d2], d2 < d1

    # We need `length` output bits plus `order` extra to reconstruct the
    # final LFSR state (state bit j after n steps equals o[n - j], so the
    # state after emitting `length` bits is bits o[length-order+1 .. length]).
    total = length + order

    # Bootstrap 2*d1 bits serially (at most 62 iterations), then double.
    if total <= 2 * d1:
        bits, _ = _bootstrap(order, seed, total)
        _, state = _bootstrap(order, seed, length)
        return bits[:length], state

    n0 = 2 * d1
    boot, _ = _bootstrap(order, seed, n0)
    bits = np.empty(total, dtype=np.uint8)
    bits[:n0] = boot
    have = n0
    while have < total:
        # largest power-of-two scale whose long lag fits in what we have
        k = 1
        while 2 * k * d1 <= have:
            k *= 2
        new = min(k * d2, total - have)  # lag d2*k >= new keeps deps in past
        lo = have
        hi = have + new
        bits[lo:hi] = bits[lo - k * d1:hi - k * d1] ^ bits[lo - k * d2:hi - k * d2]
        have = hi

    out = bits[:length]
    # final LFSR state after emitting `length` bits: bit j = o(length - j)
    state = 0
    for j in range(order):
        state |= int(bits[length - j]) << j
    return out, state
