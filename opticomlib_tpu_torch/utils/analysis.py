"""dB conversions (host-side NumPy, copied from
``opticomlib_tpu.utils.analysis``; reference utils.py:343-483)."""
from __future__ import annotations

import numpy as np

__all__ = ["db", "dbm", "idb", "idbm"]


def _is_arraylike(x) -> bool:
    if isinstance(x, (np.ndarray, list, tuple)):
        return True
    return hasattr(x, "__array__") and hasattr(x, "shape")


def db(x):
    """Linear -> dB: ``10*log10(x)``."""
    x = np.asarray(x, dtype=float) if _is_arraylike(x) else x
    if np.any(np.asarray(x) < 0):
        raise ValueError("Negative values not allowed for dB conversion.")
    return 10 * np.log10(x)


def dbm(x):
    """Power [W] -> dBm: ``10*log10(x/1mW)``."""
    x = np.asarray(x, dtype=float) if _is_arraylike(x) else x
    if np.any(np.asarray(x) < 0):
        raise ValueError("Negative values not allowed for dBm conversion.")
    return 10 * np.log10(np.asarray(x) * 1e3)


def idb(x):
    """dB -> linear: ``10**(x/10)``."""
    return 10 ** (np.asarray(x) / 10) if _is_arraylike(x) else 10 ** (x / 10)


def idbm(x):
    """dBm -> power [W]: ``1e-3 * 10**(x/10)``."""
    return 1e-3 * idb(x)
