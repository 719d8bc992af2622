"""The inputs a run makes from ``--seed``: derived seeds, the pool of bits
and the unit-normal noise draws that both the program (``noise=``) and
the plain reference take."""
from __future__ import annotations

import numpy as np
import torch

# streams of one run, each keyed under the run's seed
BITS, CALL, DRAWS, CHECK, WARM = 1, 2, 3, 4, 5


def derive(*key) -> int:
    """A 62-bit seed from the non-negative integers ``key``."""
    ss = np.random.SeedSequence([int(k) % 2**64 for k in key])
    return int(ss.generate_state(1, np.uint64)[0]) >> 2


def bits_pool(seed: int, pool: int, channels: int, n_bits: int):
    """``(pool, channels, n_bits)`` random bits (uint8), held on the
    host."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, BITS]))
    return rng.integers(0, 2, (pool, channels, n_bits), dtype=np.uint8)


def noise_rows(cfg: dict) -> list:
    """``(name, rows)`` of the unit draws the configuration consumes, in a
    fixed order: the laser's phase and RIN, one ``(4, n)`` ASE draw a noisy
    EDFA in run order, the photodiode's thermal and shot noise."""
    link = cfg["link"]
    rows = []
    if link.get("lw"):
        rows.append(("phase", 1))
    if link.get("rin") is not None:
        rows.append(("rin", 1))
    for st in link["stages"]:
        subs = st["stages"] * st["n"] if st["spec"] == "RepeatSpec" else [st]
        rows += [("ase", 4) for s in subs
                 if s["spec"] == "EDFASpec" and s.get("NF") is not None]
    if link["include_thermal"]:
        rows.append(("thermal", 1))
    if link["include_shot"]:
        rows.append(("shot", 1))
    return rows


def make(cfg: dict, n: int, seed: int, device) -> dict:
    """The draws of one channel of one call: one ``randn`` on ``device``
    from a generator seeded with ``seed``, split by :func:`noise_rows`
    (``"ase"`` a list of ``(4, n)`` views)."""
    rows = noise_rows(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(r for _, r in rows) * n, generator=gen,
                       device=device, dtype=torch.float32)
    out, at = {"ase": []}, 0
    for name, r in rows:
        d = flat[at:at + r * n]
        at += r * n
        if name == "ase":
            out["ase"].append(d.view(4, n))
        else:
            out[name] = d
    return out


def channel_draws(cfg: dict, n: int, seed: int, key: int, k: int, ch: int,
                  device) -> dict:
    """The draws of channel ``ch`` of call ``k`` of the run's stream
    ``key`` (:data:`CALL`, :data:`WARM`)."""
    return make(cfg, n, derive(seed, DRAWS, key, k, ch), device)


def call_draws(cfg: dict, n: int, channels: int, seed: int, key: int,
               k: int, device, only=None) -> list:
    """The draws of call ``k`` of the run's stream ``key``, one dict a
    channel; ``only``: the channels to draw (``None`` in the others'
    places), all by default."""
    return [channel_draws(cfg, n, seed, key, k, ch, device)
            if only is None or ch in only else None
            for ch in range(channels)]
