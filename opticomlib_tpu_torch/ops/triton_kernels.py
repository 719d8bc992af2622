"""Triton kernels for the split-step solver's pointwise passes.

Needs ``triton`` and a CUDA card: :mod:`opticomlib_tpu_torch.ops.kernels`
imports this module on the first launch on a CUDA tensor, never at import.

* ``_nl_halfstep_kernel`` replaces ``opticomlib_tpu/ops/pallas_kernels.py``
  ``_nl_kernel`` (the frozen nonlinear half-step, ops/ssfm.py:162-164).
* ``_cmul_kernel`` replaces ``pallas_kernels._cmul_kernel`` (the spectral
  multiply and the post-IFFT rotation, ops/ssfm.py:167-168).

What bounds them on an H100: HBM bandwidth.  Per complex64 sample
``nl_halfstep`` reads 8 B and writes 16 B (field and rotation), ``cmul``
reads 16 B and writes 8 B, against a handful of flops and one cos/sin.
The design is one flat pass per call over complex64 viewed as interleaved
float32 pairs (``torch.view_as_real``): each block loads a (BLOCK, 2) tile,
so a thread reads whole (re, im) pairs in wide vector loads, and splits it
in registers (``tl.split``; ``tl.join`` for the store).  Nothing is
de-interleaved in device memory; blocks are independent, with no shared
memory and no cross-block traffic.  cos/sin come from libdevice (accurate
to an ulp or two), not the ``*.approx`` instructions that
``tl.cos``/``tl.sin`` may lower to: the rotation is applied twice per step
for tens of steps.
"""
from __future__ import annotations

import torch
import triton
import triton.language as tl

try:  # the libdevice module moved between Triton releases
    from triton.language.extra import libdevice
except ImportError:  # pragma: no cover - older Triton
    from triton.language.extra.cuda import libdevice

_BLOCK = 1024
_WARPS = 4


@triton.jit
def _nl_halfstep_kernel(a_ptr, b_ptr, h_ptr, coeff, n,
                        BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    pair = 2 * offs[:, None] + tl.arange(0, 2)[None, :]   # (BLOCK, 2)
    mask = pair < 2 * n
    re, im = tl.split(tl.load(a_ptr + pair, mask=mask, other=0.0))
    phi = coeff * (re * re + im * im)
    c = libdevice.cos(phi)
    s = libdevice.sin(phi)
    tl.store(h_ptr + pair, tl.join(c, s), mask=mask)
    tl.store(b_ptr + pair, tl.join(re * c - im * s, re * s + im * c),
             mask=mask)


@triton.jit
def _cmul_kernel(a_ptr, b_ptr, c_ptr, ncol, b_row_stride,
                 BLOCK: tl.constexpr):
    # grid: (column blocks, rows); B is either A's shape (b_row_stride =
    # ncol) or one row broadcast over A's rows (b_row_stride = 0)
    col = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    row = tl.program_id(1).to(tl.int64)
    re_im = tl.arange(0, 2)[None, :]
    ia = 2 * (row * ncol + col)[:, None] + re_im           # (BLOCK, 2)
    ib = 2 * (row * b_row_stride + col)[:, None] + re_im
    mask = (col < ncol)[:, None] & (re_im < 2)
    ar, ai = tl.split(tl.load(a_ptr + ia, mask=mask, other=0.0))
    br, bi = tl.split(tl.load(b_ptr + ib, mask=mask, other=0.0))
    tl.store(c_ptr + ia, tl.join(ar * br - ai * bi, ar * bi + ai * br),
             mask=mask)


def launch_nl_halfstep(A: torch.Tensor, coeff: float, B: torch.Tensor,
                       H: torch.Tensor) -> None:
    n = A.numel()
    grid = (triton.cdiv(n, _BLOCK),)
    # Triton launches on the current device's current stream
    with torch.cuda.device(A.device):
        _nl_halfstep_kernel[grid](
            torch.view_as_real(A), torch.view_as_real(B),
            torch.view_as_real(H), coeff, n, BLOCK=_BLOCK, num_warps=_WARPS)


def launch_cmul(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> None:
    ncol = A.shape[-1] if A.ndim else 1
    nrow = A.numel() // ncol
    b_row_stride = ncol if B.shape == A.shape else 0
    if nrow > 65535:
        raise ValueError(f"cmul takes at most 65535 rows, got {nrow}")
    grid = (triton.cdiv(ncol, _BLOCK), nrow)
    with torch.cuda.device(A.device):
        _cmul_kernel[grid](
            torch.view_as_real(A), torch.view_as_real(B),
            torch.view_as_real(C), ncol, b_row_stride, BLOCK=_BLOCK,
            num_warps=_WARPS)
