"""The Triton kernels of the split-step solver's nonlinear kicks.

Needs ``triton`` and a CUDA card: :mod:`opticomlib_tpu_torch.ops.kernels`
imports this module on the first launch on a CUDA tensor, never at import.

``_nl_halfstep_kernel`` replaces ``opticomlib_tpu/ops/pallas_kernels.py``
``_nl_kernel`` (the frozen nonlinear half-step, ops/ssfm.py:162-164).  The
solver's other pointwise pass, the complex product ``cmul``, is a CUDA C++
kernel (``csrc/cmul.cu``).

What bounds it on an H100: HBM bandwidth.  Per complex64 sample it reads
8 B and writes 16 B (field and rotation), against a handful of flops and
one cos/sin.  The design is one flat pass per call over complex64 viewed as
interleaved float32 pairs (``torch.view_as_real``): each block loads a
(BLOCK, 2) tile, so a thread reads whole (re, im) pairs in wide vector
loads, and splits it in registers (``tl.split``; ``tl.join`` for the
store).  Nothing is de-interleaved in device memory; blocks are
independent, with no shared memory and no cross-block traffic.  cos/sin
come from libdevice (accurate to an ulp or two), not the ``*.approx``
instructions that ``tl.cos``/``tl.sin`` may lower to: the rotation is
applied twice per step for tens of steps.

``_strang_kicks_kernel`` replaces no TPU kernel: it is the pass XLA fuses
at each boundary of the fixed-step 4th-order scheme's Strang substeps
(``opticomlib_tpu/ops/ssfm.py:319-338``): the inverse FFT's ``1/n``, the
trailing kick of one substep and the leading kick of the next.  Three
passes through HBM (48 B a sample, and 8 B more for each kick's discarded
rotation) become one that reads and writes the field once (16 B).  It is
bound by HBM bandwidth too, with two cos/sin pairs a sample in the shadow
of the traffic at 4 samples a thread.  Each rotation is the kick kernel's,
expression for expression, with ``|x|^2`` recomputed after the first, so
the pass rounds as the three launches it replaces do.
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
# the boundary pass's tile, 4 samples a thread: at the kick's 8 a thread
# its two cos/sin pairs ran 0.236 ms a pass on (2, 2^24) against 0.183 on
# an H100 (scripts/sweep_torch_kernels.py kicks)
_KICKS_BLOCK = 256
_KICKS_WARPS = 2


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
def _strang_kicks_kernel(a_ptr, b_ptr, scale, c1, c2, n,
                         TWO: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    pair = 2 * offs[:, None] + tl.arange(0, 2)[None, :]   # (BLOCK, 2)
    mask = pair < 2 * n
    re, im = tl.split(tl.load(a_ptr + pair, mask=mask, other=0.0))
    re = re * scale
    im = im * scale
    phi = c1 * (re * re + im * im)
    c = libdevice.cos(phi)
    s = libdevice.sin(phi)
    re, im = re * c - im * s, re * s + im * c
    if TWO:
        phi = c2 * (re * re + im * im)
        c = libdevice.cos(phi)
        s = libdevice.sin(phi)
        re, im = re * c - im * s, re * s + im * c
    tl.store(b_ptr + pair, tl.join(re, im), mask=mask)


def launch_nl_halfstep(A: torch.Tensor, coeff: float, B: torch.Tensor,
                       H: torch.Tensor) -> None:
    n = A.numel()
    grid = (triton.cdiv(n, _BLOCK),)
    # Triton launches on the current device's current stream
    with torch.cuda.device(A.device):
        _nl_halfstep_kernel[grid](
            torch.view_as_real(A), torch.view_as_real(B),
            torch.view_as_real(H), coeff, n, BLOCK=_BLOCK, num_warps=_WARPS)


def launch_strang_kicks(A: torch.Tensor, scale: float, c1: float, c2,
                        B: torch.Tensor) -> None:
    n = A.numel()
    grid = (triton.cdiv(n, _KICKS_BLOCK),)
    with torch.cuda.device(A.device):
        _strang_kicks_kernel[grid](
            torch.view_as_real(A), torch.view_as_real(B), scale, c1,
            0.0 if c2 is None else c2, n, TWO=c2 is not None,
            BLOCK=_KICKS_BLOCK, num_warps=_KICKS_WARPS)
