"""Keyed randomness for the staged devices' noise (port of
``opticomlib_tpu.rng``).

The reference draws every noise realization from NumPy's global legacy RNG
on the host (reference devices.py:485-506, 930-936, 1521-1527).  As in the
JAX package there are three ways to get keyed noise instead, in precedence
order:

1. pass ``key=`` (an int seed or a ``torch.Generator``) to a device call
   (``LASER``, ``EDFA``, ``PD``);
2. seed the global stream: ``gv(seed=42)`` or ``rng.seed(42)`` — devices
   then take consecutive keys from it (reproducible whole-script runs);
3. do neither — devices fall back to the reference's legacy NumPy draws.

A key becomes a ``torch.Generator`` on the device of the signal it noises,
so keyed draws are made on the card.  Torch's Philox stream cannot give
JAX's threefry numbers: keyed runs of the two packages agree in
distribution only, while legacy runs under one ``np.random.seed`` see the
same draws.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["seed", "clear", "is_seeded", "next_key", "resolve", "KeyLike"]

KeyLike = Union[int, torch.Generator]

_stream: Optional[torch.Generator] = None


def seed(n: int) -> None:
    """Seed the global key stream (also reachable as ``gv(seed=n)``)."""
    global _stream
    _stream = torch.Generator().manual_seed(int(n))


def clear() -> None:
    """Disable the global stream (devices revert to legacy NumPy noise)."""
    global _stream
    _stream = None


def is_seeded() -> bool:
    return _stream is not None


def next_key() -> int:
    """Draw the next key, an int seed, from the global stream (advances
    the stream)."""
    if _stream is None:
        raise RuntimeError(
            "global RNG stream not seeded; call rng.seed(n) or gv(seed=n)")
    return int(torch.randint(0, 2**62, (1,), generator=_stream))


def resolve(key: Optional[KeyLike],
            device: Union[str, torch.device] = "cpu"
            ) -> Optional[torch.Generator]:
    """Resolve a device's ``key=`` argument to a generator on ``device``.

    Explicit ``key`` wins (an int seeds a new generator; a generator must
    already be on ``device``); else the global stream if seeded; else
    ``None`` (the caller uses the legacy NumPy draws)."""
    device = torch.device(device)
    if key is None:
        if not is_seeded():
            return None
        key = next_key()
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(
                f"key is a generator on {key.device}, the signal is on "
                f"{device}")
        return key
    return torch.Generator(device=device).manual_seed(int(key))
