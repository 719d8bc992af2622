"""The comparison that decides ``correct``: what the timed path produced
for a sample of its calls against the plain reference on the same bits
and draws.  What is compared is the entry driver's (``NAMES`` and
``readings`` of ``entries/<entry>.py``); here the rows are taken, the
worst over them kept, and each number judged against its limit in
``limits/<cell>.json``."""
from __future__ import annotations

import math


def row(entry, side, v, ref) -> dict:
    """One channel's numbers (``side`` ``None``: the side gave no answer
    for it); a NaN reads as infinite."""
    if side is None:
        return {k: math.inf for k in entry.NAMES}
    r = entry.readings(side, v, ref)
    if set(r) != set(entry.NAMES):
        raise KeyError(f"readings {sorted(r)} are not {entry.NAMES}")
    return {k: (math.inf if isinstance(x, float) and math.isnan(x) else x)
            for k, x in r.items()}


def worst(rows: list, names) -> dict:
    """The largest of each number over ``rows`` (infinite without any)."""
    return {k: max((r[k] for r in rows), default=math.inf) for k in names}


def judge(values: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without a number, fails."""
    return set(values) == set(limits) and all(
        values[k] <= limits[k] for k in values)
