"""Hand-written Hopper kernels of the link's main path, each beside its plain
PyTorch version and a launch counter.

This is the counterpart of ``opticomlib_tpu/ops/pallas_kernels.py``:

============  ========================  ===============================
wrapper       kernel                    replaces (TPU kernel)
============  ========================  ===============================
nl_halfstep   Triton, triton_kernels    pallas_kernels._nl_kernel
cmul          Triton, triton_kernels    pallas_kernels._cmul_kernel
histogram2d   CUDA C++, csrc/*.cu       pallas_kernels._hist_kernel
============  ========================  ===============================

A wrapper given CPU tensors computes its plain version (``*_ref``); given
CUDA tensors it launches its kernel or raises.  There is no other switch.
:data:`LAUNCHES` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that it went through the kernels.

Neither ``triton`` nor the compiled library is touched at import: the
Triton module is imported, and the CUDA library built (``_build``), on the
first launch on a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["nl_halfstep", "nl_halfstep_ref", "cmul", "cmul_ref",
           "histogram2d", "histogram2d_ref", "LAUNCHES", "reset_launches"]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"nl_halfstep": 0, "cmul": 0, "histogram2d": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or any
    other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"tensors must all be on the CPU or all on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# nonlinear half-step
# ---------------------------------------------------------------------------
def nl_halfstep_ref(A: torch.Tensor, coeff) -> tuple:
    """Plain version: ``H = exp(i*coeff*|A|^2)``, ``B = A*H``."""
    phi = (A.real * A.real + A.imag * A.imag) * float(coeff)
    H = torch.polar(torch.ones_like(phi), phi)
    return A * H, H


def nl_halfstep(A: torch.Tensor, coeff) -> tuple:
    """Frozen nonlinear half-step of the split-step solver.

    ``A``: complex64, any shape.  ``coeff``: ``gamma*h/2`` [1/W], a float.
    Returns ``(B, H)``: the rotated field ``B = A*exp(i*coeff*|A|^2)`` and
    the rotation ``H``, which the step applies again after the linear
    substep (one cos/sin pass per step)."""
    _check(A, "A", torch.complex64)
    if not _on_cuda(A):
        return nl_halfstep_ref(A, coeff)
    from . import triton_kernels
    B = torch.empty_like(A)
    H = torch.empty_like(A)
    if A.numel():
        triton_kernels.launch_nl_halfstep(A, float(coeff), B, H)
        LAUNCHES["nl_halfstep"] += 1
    return B, H


# ---------------------------------------------------------------------------
# complex multiply
# ---------------------------------------------------------------------------
def cmul_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: ``A * B``."""
    return A * B


def cmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Complex product ``A * B`` of complex64 tensors: ``B`` has ``A``'s
    shape, or is 1-D along ``A``'s last axis and broadcast over its leading
    rows (a 2-pol field times one spectral factor)."""
    _check(A, "A", torch.complex64)
    _check(B, "B", torch.complex64)
    if B.shape != A.shape and not (B.ndim == 1 and A.ndim >= 1
                                   and B.shape[0] == A.shape[-1]):
        raise ValueError(
            f"cmul takes B of A's shape {tuple(A.shape)} or a 1-D B along "
            f"A's last axis; got {tuple(B.shape)}")
    if not _on_cuda(A, B):
        return cmul_ref(A, B)
    from . import triton_kernels
    C = torch.empty_like(A)
    if A.numel():
        triton_kernels.launch_cmul(A, B, C)
        LAUNCHES["cmul"] += 1
    return C


# ---------------------------------------------------------------------------
# 2-D histogram
# ---------------------------------------------------------------------------
def histogram2d_ref(t_idx: torch.Tensor, y_idx: torch.Tensor, nt: int,
                    ny: int) -> torch.Tensor:
    """Plain version: ``bincount`` over ``t*ny + y`` on the in-range pairs."""
    ok = (t_idx >= 0) & (t_idx < nt) & (y_idx >= 0) & (y_idx < ny)
    flat = t_idx[ok].to(torch.int64) * ny + y_idx[ok].to(torch.int64)
    return torch.bincount(flat, minlength=nt * ny).to(
        torch.float32).reshape(nt, ny)


def histogram2d(t_idx: torch.Tensor, y_idx: torch.Tensor, nt: int,
                ny: int) -> torch.Tensor:
    """``counts[i, j] = #{k : t_idx[k] == i and y_idx[k] == j}`` as float32
    (nt, ny).  Indices are int32 and 1-D; pairs with an index out of range
    (e.g. -1 for a masked sample) are dropped.  Counts are exact integers
    (up to 2^24 per bin)."""
    _check(t_idx, "t_idx", torch.int32)
    _check(y_idx, "y_idx", torch.int32)
    if t_idx.ndim != 1 or t_idx.shape != y_idx.shape:
        raise ValueError(
            f"t_idx and y_idx must be 1-D of one length, got "
            f"{tuple(t_idx.shape)} and {tuple(y_idx.shape)}")
    nt, ny = int(nt), int(ny)
    if nt < 1 or ny < 1 or nt * ny >= 2**31:
        raise ValueError(f"bad histogram shape ({nt}, {ny})")
    if not _on_cuda(t_idx, y_idx):
        return histogram2d_ref(t_idx, y_idx, nt, ny)
    from ._build import load_library
    lib = load_library()
    counts = torch.empty((nt, ny), dtype=torch.int32, device=t_idx.device)
    out = torch.empty((nt, ny), dtype=torch.float32, device=t_idx.device)
    with torch.cuda.device(t_idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.histogram2d_launch(
            ctypes.c_void_p(t_idx.data_ptr()),
            ctypes.c_void_p(y_idx.data_ptr()),
            ctypes.c_longlong(t_idx.numel()), ctypes.c_int(nt),
            ctypes.c_int(ny), ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"histogram2d kernel launch failed: CUDA error "
                           f"{err} ({lib.error_string(err).decode()})")
    LAUNCHES["histogram2d"] += 1
    return out
