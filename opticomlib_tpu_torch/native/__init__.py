"""Native (C++) host helpers, built on first use.

The shared library is compiled from ``_native.cpp`` with ``g++ -O3`` on the
first call into ``build/native/`` at the repository root, named by a hash of
the source and the flags (an edited source is rebuilt, an unchanged one
reused), and bound through :mod:`ctypes`.  This is host work: arrays are
NumPy arrays, and a tensor on any device is copied to the host first.  Every
function has a NumPy fallback with the same results, taken with a
``RuntimeWarning`` where no compiler is found: a machine without a
toolchain loses speed, not functionality.

Public API (the names of ``opticomlib_tpu.native``)
---------------------------------------------------
``available()``                    - True if the native library loaded.
``lfsr_prbs(order, seed, n)``      - bit-serial PRBS (oracle for ops/prbs).
``bit_error_count(a, b)``          - #(a[i] != b[i]) over uint8 arrays.
``pack_bits(bits)`` / ``unpack_bits(data, n_bits)`` - bitstream packing.
"""
from __future__ import annotations

import ctypes
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops import _build
from ..ops.prbs import PRBS_TAPS, _bootstrap

__all__ = ["available", "lfsr_prbs", "bit_error_count", "pack_bits",
           "unpack_bits"]

_SRC = Path(__file__).resolve().parent / "_native.cpp"
BUILD_DIR = _build.BUILD_DIR.parent / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of ``_native.cpp`` lives (built or not)."""
    return _build.cached_path(_SRC, CXX_FLAGS, BUILD_DIR, "native")


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        lib = _build.compiled_library(CXX, CXX_FLAGS, _SRC, BUILD_DIR,
                                      "native")
    except (OSError, RuntimeError) as e:
        warnings.warn(f"opticomlib_tpu_torch.native: build/load failed "
                      f"({e}); using NumPy fallbacks.", RuntimeWarning)
        return None
    lib.lfsr_prbs.restype = ctypes.c_uint64
    lib.lfsr_prbs.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                              ctypes.c_int64, ctypes.c_void_p]
    lib.bit_error_count.restype = ctypes.c_int64
    lib.bit_error_count.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64]
    lib.pack_bits.restype = None
    lib.pack_bits.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p]
    lib.unpack_bits.restype = None
    lib.unpack_bits.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call (one try a
    process)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _build_and_load()
    return _lib


def _host(x, dtype) -> np.ndarray:
    """``x`` as a contiguous host array of ``dtype`` (a tensor is copied
    off its device)."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def available() -> bool:
    """True when the compiled native library is loaded."""
    return _get() is not None


def lfsr_prbs(order: int, seed: int, n: int) -> Tuple[np.ndarray, int]:
    """Bit-serial Galois LFSR: ``n`` output bits and the continuation
    state.

    The semantics of :func:`opticomlib_tpu_torch.ops.prbs._bootstrap` (and
    of the reference's per-bit loop, reference devices.py:170-175): the
    independent native oracle for the vectorized generator."""
    if order not in PRBS_TAPS:
        raise ValueError(f"unsupported PRBS order {order}")
    lib = _get()
    if lib is None:
        return _bootstrap(order, seed, int(n))
    out = np.empty(int(n), dtype=np.uint8)
    state = lib.lfsr_prbs(int(order), int(PRBS_TAPS[order][1]), int(seed),
                          int(n), _ptr(out))
    return out, int(state)


def bit_error_count(a, b) -> int:
    """Number of positions where ``a != b`` (uint8 byte-per-bit arrays)."""
    a, b = _host(a, np.uint8), _host(b, np.uint8)
    if a.shape != b.shape:
        raise ValueError("a and b must have the same shape")
    lib = _get()
    if lib is None:
        return int(np.sum(a != b))
    return int(lib.bit_error_count(_ptr(a), _ptr(b), a.size))


def pack_bits(bits) -> np.ndarray:
    """Pack byte-per-bit uint8 -> bitstream bytes (LSB-first)."""
    bits = _host(bits, np.uint8)
    lib = _get()
    if lib is None:
        return np.packbits(bits, bitorder="little")
    out = np.zeros((bits.size + 7) // 8, dtype=np.uint8)
    lib.pack_bits(_ptr(bits), bits.size, _ptr(out))
    return out


def unpack_bits(data, n_bits: int) -> np.ndarray:
    """Unpack bitstream bytes (LSB-first) -> byte-per-bit uint8."""
    data = _host(data, np.uint8)
    if not 0 <= int(n_bits) <= 8 * data.size:
        raise ValueError(f"{n_bits} bits asked of {data.size} bytes")
    lib = _get()
    if lib is None:
        return np.unpackbits(data, count=int(n_bits), bitorder="little")
    out = np.empty(int(n_bits), dtype=np.uint8)
    lib.unpack_bits(_ptr(data), int(n_bits), _ptr(out))
    return out
