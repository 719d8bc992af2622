"""Hand-written Hopper kernels of the link's main path, each beside its plain
PyTorch version and a launch counter.

This is the counterpart of ``opticomlib_tpu/ops/pallas_kernels.py``:

==============  ========================  =============================
wrapper         kernel                    replaces (TPU kernel)
==============  ========================  =============================
nl_halfstep     Triton, triton_kernels    pallas_kernels._nl_kernel
strang_kicks    Triton, triton_kernels    none (XLA's fusion)
cmul            CUDA C++, csrc/*.cu       pallas_kernels._cmul_kernel
spectral_phase  CUDA C++, csrc/cmul.cu    none (XLA's fusion)
cmul_max        CUDA C++, csrc/cmul.cu    none (XLA's fusion)
pencil          CUDA C++, csrc/pencil.cu  none (an einsum, XLA's fusion)
histogram2d     CUDA C++, csrc/*.cu       pallas_kernels._hist_kernel
adc_quantize    CUDA C++, csrc/*.cu       pallas_kernels._adc_kernel
fir_filter      CUDA C++, csrc/*.cu       pallas_kernels._fir_kernel
fbg_rk4         CUDA C++, csrc/*.cu       devices._fbg_rk4 (a lax.scan)
==============  ========================  =============================

``spectral_phase`` and ``cmul_max`` are the adaptive split step's passes
around its inverse FFT (``ops/ssfm.ssfm_while_inside``): the linear factor
built in registers with the inverse's 1/n folded in, and the trailing
product with its ``max|A|^2``.  ``cmul_max`` has two wrappers over one
kernel: the product with its maximum (:func:`cmul_max`) and the maximum
alone (:func:`power_max`); both count as ``cmul_max`` launches.

``strang_kicks`` is the fixed-step 4th-order scan's pass at each boundary
of its Strang substeps (``ops/ssfm.ssfm_o4_scan_inside``): the inverse
FFT's 1/n, the trailing kick of one substep and the leading kick of the
next, in registers.

``pencil`` is the pencil FFT's local passes between its all-to-alls
(``parallel/dfft.py``), each written straight into the layout the next
all-to-all sends: the rank-axis DFT with or without its twiddle
(:func:`pencil_dft`) and the inverse's twiddle with its pack
(:func:`pencil_twiddle_pack`); both count as ``pencil`` launches.

``histogram2d`` has two wrappers over one kernel family: the table of index
pairs (:func:`histogram2d`, the Pallas kernel's function) and its row-batched
form (:func:`histogram_rows`, the JAX package's ``vmap`` over a row scatter in
``ops/eyeana.py``); both count as ``histogram2d`` launches.
``adc_quantize`` has two wrappers over one kernel source: kernel mode
(:func:`adc_quantize`, the Pallas kernel's function) and link mode
(:func:`adc_quantize_link`, the fused link's ADC); both count as
``adc_quantize`` launches.

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
import functools

import numpy as np
import torch

__all__ = ["nl_halfstep", "nl_halfstep_ref", "strang_kicks",
           "strang_kicks_ref", "cmul", "cmul_ref",
           "spectral_scale", "spectral_phase", "spectral_phase_ref",
           "cmul_max", "cmul_max_ref", "power_max", "power_max_ref",
           "pencil_dft", "pencil_dft_ref", "pencil_twiddle_pack",
           "pencil_twiddle_pack_ref",
           "histogram2d", "histogram2d_ref", "histogram_rows",
           "histogram_rows_ref", "HIST_MAX_ROWS", "adc_quantize",
           "adc_quantize_ref", "adc_quantize_link", "adc_quantize_link_ref",
           "fir_filter", "fir_filter_ref", "FIR_MAX_TAPS", "fbg_rk4",
           "fbg_rk4_ref", "LAUNCHES", "reset_launches"]

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"nl_halfstep": 0, "strang_kicks": 0, "cmul": 0,
            "spectral_phase": 0, "cmul_max": 0, "pencil": 0,
            "histogram2d": 0, "adc_quantize": 0, "fir_filter": 0,
            "fbg_rk4": 0}


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


def _out(out, A: torch.Tensor, k: int) -> tuple:
    """The ``k`` output tensors a wrapper writes: new ones like ``A``, or the
    caller's ``out`` (contiguous, ``A``'s shape and dtype; a row of a larger
    tensor, say)."""
    if out is None:
        return tuple(torch.empty_like(A) for _ in range(k))
    for t in out:
        _check(t, "out", A.dtype)
        if t.shape != A.shape or t.device != A.device:
            raise ValueError(f"out must be {tuple(A.shape)} on {A.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return tuple(out)


def nl_halfstep(A: torch.Tensor, coeff, out=None) -> tuple:
    """Frozen nonlinear half-step of the split-step solver.

    ``A``: complex64, any shape.  ``coeff``: ``gamma*h/2`` [1/W], a float.
    Returns ``(B, H)``: the rotated field ``B = A*exp(i*coeff*|A|^2)`` and
    the rotation ``H``, which the step applies again after the linear
    substep (one cos/sin pass per step).  ``out``: ``(B, H)`` to write
    into."""
    _check(A, "A", torch.complex64)
    if not _on_cuda(A):
        B, H = nl_halfstep_ref(A, coeff)
        if out is None:
            return B, H
        out = _out(out, A, 2)
        out[0].copy_(B)
        out[1].copy_(H)
        return out
    from . import triton_kernels
    B, H = _out(out, A, 2)
    if A.numel():
        triton_kernels.launch_nl_halfstep(A, float(coeff), B, H)
        LAUNCHES["nl_halfstep"] += 1
    return B, H


def strang_kicks_ref(A: torch.Tensor, scale, c1, c2=None) -> torch.Tensor:
    """Plain version: ``x = A*scale`` (each float32 component times the
    float32 ``scale``), then ``x = nl_halfstep_ref(x, c1)[0]`` and, with
    ``c2``, ``x = nl_halfstep_ref(x, c2)[0]``."""
    s = float(np.float32(scale))
    x = torch.view_as_complex(torch.view_as_real(A) * s)
    x = nl_halfstep_ref(x, c1)[0]
    return x if c2 is None else nl_halfstep_ref(x, c2)[0]


def strang_kicks(A: torch.Tensor, scale, c1, c2=None,
                 out=None) -> torch.Tensor:
    """One pass at a boundary of Strang substeps: ``x = A*scale``, then the
    rotation ``x *= exp(i*c1*|x|^2)`` and, with ``c2``, ``x *=
    exp(i*c2*|x|^2)`` at the magnitudes after the first.

    ``A``: complex64, any shape.  ``scale``: the inverse FFT's 1/n where the
    caller folds it (a power of two, exact), else 1.  ``c1``, ``c2``:
    ``gamma*h/2`` of the two kicks [1/W].  Each rotation rounds as an
    :func:`nl_halfstep` launch does; no rotation is written.  Writes ``x``
    into ``out`` (default: ``A``, in place) and returns it."""
    _check(A, "A", torch.complex64)
    B = A if out is None else _out((out,), A, 1)[0]
    if not _on_cuda(A, B):
        return B.copy_(strang_kicks_ref(A, scale, c1, c2))
    from . import triton_kernels
    if A.numel():
        triton_kernels.launch_strang_kicks(
            A, float(np.float32(scale)), float(c1),
            None if c2 is None else float(c2), B)
        LAUNCHES["strang_kicks"] += 1
    return B


# ---------------------------------------------------------------------------
# complex multiply
# ---------------------------------------------------------------------------
def cmul_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: ``A * B``."""
    return A * B


def cmul(A: torch.Tensor, B: torch.Tensor, out=None) -> torch.Tensor:
    """Complex product ``A * B`` of complex64 tensors: ``B`` has ``A``'s
    shape, or is 1-D along ``A``'s last axis and broadcast over its leading
    rows (a 2-pol field times one spectral factor).  The kernel rounds as
    ``A * B`` does on the card: ``re = fma(ar, br, -(ai*bi))``,
    ``im = fma(ar, bi, ai*br)``.  ``out``: the tensor to write the product
    into (it may be ``A``: each element is read before it is written)."""
    _check(A, "A", torch.complex64)
    _check(B, "B", torch.complex64)
    if B.shape != A.shape and not (B.ndim == 1 and A.ndim >= 1
                                   and B.shape[0] == A.shape[-1]):
        raise ValueError(
            f"cmul takes B of A's shape {tuple(A.shape)} or a 1-D B along "
            f"A's last axis; got {tuple(B.shape)}")
    C = None if out is None else _out((out,), A, 1)[0]
    if not _on_cuda(A, B):
        return cmul_ref(A, B) if C is None else torch.mul(A, B, out=C)
    from . import _build
    lib = _build.load_library("cmul")
    if C is None:
        C = torch.empty_like(A)
    if A.numel():
        ncol = A.shape[-1] if A.ndim else 1
        with torch.cuda.device(A.device):
            err = lib.cmul_launch(
                ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(B.data_ptr()),
                ctypes.c_void_p(C.data_ptr()),
                ctypes.c_longlong(A.numel() // ncol), ctypes.c_longlong(ncol),
                ctypes.c_int(int(B.shape != A.shape)),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(lib, err, "cmul")
        LAUNCHES["cmul"] += 1
    return C


# ---------------------------------------------------------------------------
# the adaptive split step's passes around the inverse FFT
# ---------------------------------------------------------------------------
def spectral_scale(n: int) -> float:
    """The inverse FFT's ``1/n`` that :func:`spectral_phase` folds into its
    factor: ``2^-log2(n)`` at a power-of-two ``n`` (exact, so the inverse
    then runs with ``norm="forward"``), else 1 (the inverse keeps its own
    ``1/n``)."""
    n = int(n)
    return 2.0 ** -(n.bit_length() - 1) if n > 0 and n & (n - 1) == 0 \
        else 1.0


def spectral_phase_ref(X: torch.Tensor, phi: torch.Tensor, loss,
                       h) -> torch.Tensor:
    """Plain version: ``X * polar(loss*s, phi*h)``, ``s`` the
    :func:`spectral_scale` of ``X``'s rows: the linear factor of
    ``ops/ssfm._lin_factor`` with the inverse FFT's ``1/n`` folded in."""
    ls = np.float32(loss) * np.float32(spectral_scale(X.shape[-1]))
    th = phi * float(np.float32(h))
    return X * torch.polar(torch.full_like(th, float(ls)), th)


def spectral_phase(X: torch.Tensor, phi: torch.Tensor, loss,
                   h) -> torch.Tensor:
    """Multiply the spectrum ``X`` (complex64, last axis the frequency) in
    place by ``loss*s * (cos(phi*h), sin(phi*h))``: the adaptive step's
    linear factor built in registers, ``phi`` (float32, one row) broadcast
    over ``X``'s rows, ``s`` the inverse FFT's ``1/n`` where
    :func:`spectral_scale` folds it.  ``loss`` and ``h``: float32 values.
    Rounds as :func:`spectral_phase_ref` does on the card (``phi*h``,
    precise cos and sin, each times ``loss*s``, then ``cmul``'s product).
    Returns ``X``."""
    _check(X, "X", torch.complex64)
    _check(phi, "phi", torch.float32)
    if X.ndim < 1 or phi.ndim != 1 or phi.shape[0] != X.shape[-1]:
        raise ValueError(
            f"spectral_phase takes X (..., n) and a 1-D phi of n, got "
            f"{tuple(X.shape)} and {tuple(phi.shape)}")
    if not _on_cuda(X, phi):
        return X.copy_(spectral_phase_ref(X, phi, loss, h))
    from . import _build
    lib = _build.load_library("cmul")
    if X.numel():
        ls = np.float32(loss) * np.float32(spectral_scale(X.shape[-1]))
        ncol = X.shape[-1]
        with torch.cuda.device(X.device):
            err = lib.spectral_phase_launch(
                ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(phi.data_ptr()),
                ctypes.c_longlong(X.numel() // ncol), ctypes.c_longlong(ncol),
                ctypes.c_float(np.float32(h)), ctypes.c_float(ls),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(lib, err, "spectral_phase")
        LAUNCHES["spectral_phase"] += 1
    return X


def power_max_ref(A: torch.Tensor) -> torch.Tensor:
    """Plain version: ``max(re^2 + im^2)`` as a 0-d float32 tensor (NaN
    wins)."""
    return torch.view_as_real(A).square().sum(-1).max()


def cmul_max_ref(A: torch.Tensor, H: torch.Tensor) -> tuple:
    """Plain version: ``C = A * H`` and :func:`power_max_ref` of ``C``."""
    C = A * H
    return C, power_max_ref(C)


#: the max kernels' two-word u32 scratch per (device index, stream): zero
#: between launches (the last CTA of a launch zeroes it)
_max_scratch: dict = {}


def _max_launch(fn: str, A: torch.Tensor, H, C, m) -> torch.Tensor:
    """Launch ``cmul_max_launch`` (``H``, ``C`` given) or
    ``power_max_launch`` on CUDA tensors, the maximum into ``m`` (a new 0-d
    float32 tensor when None)."""
    from . import _build
    lib = _build.load_library("cmul")
    dev = A.device
    stream = _raw_stream(dev.index)
    scratch = _max_scratch.get((dev.index, stream))
    with torch.cuda.device(dev):
        if scratch is None:
            scratch = _max_scratch[(dev.index, stream)] = torch.zeros(
                2, dtype=torch.int32, device=dev)
        if m is None:
            m = torch.empty((), dtype=torch.float32, device=dev)
        ptrs = [A.data_ptr()] + ([] if H is None else [H.data_ptr(),
                                                       C.data_ptr()])
        err = getattr(lib, fn)(*ptrs, A.numel(), scratch.data_ptr(),
                               m.data_ptr(), stream)
    if err:
        # a refused or failed launch may leave the scratch behind
        _max_scratch.pop((dev.index, stream), None)
        _build.check(lib, err, "cmul_max")
    LAUNCHES["cmul_max"] += 1
    return m


def _max_args(A: torch.Tensor, m) -> None:
    _check(A, "A", torch.complex64)
    if not A.numel():
        raise ValueError("the maximum of an empty tensor is not defined")
    if m is not None:
        _check(m, "m", torch.float32)
        if m.ndim != 0 or m.device != A.device:
            raise ValueError(f"m must be a 0-d tensor on {A.device}")


def cmul_max(A: torch.Tensor, H: torch.Tensor, out=None, m=None) -> tuple:
    """``C = A * H`` of complex64 tensors of one shape, rounded as
    :func:`cmul`, and ``max(re^2 + im^2)`` over ``C`` as a 0-d float32
    tensor on ``A``'s device, in one pass: the adaptive step's trailing
    product and the maximum that sets its next step.  Bit-equal to
    :func:`cmul_max_ref` (the maximum is order-free; NaN wins, as in
    ``torch.max``).  ``out``: the tensor to write ``C`` into (it may be
    ``A``); ``m``: the 0-d tensor to write the maximum into.  Returns
    ``(C, m)``."""
    _max_args(A, m)
    _check(H, "H", torch.complex64)
    if H.shape != A.shape:
        raise ValueError(f"cmul_max takes H of A's shape {tuple(A.shape)}, "
                         f"got {tuple(H.shape)}")
    C = None if out is None else _out((out,), A, 1)[0]
    if not _on_cuda(A, H):
        Cr, mr = cmul_max_ref(A, H)
        return (Cr if C is None else C.copy_(Cr),
                mr if m is None else m.copy_(mr))
    if C is None:
        C = torch.empty_like(A)
    return C, _max_launch("cmul_max_launch", A, H, C, m)


def power_max(A: torch.Tensor) -> torch.Tensor:
    """``max(re^2 + im^2)`` of a complex64 tensor as a 0-d float32 tensor
    on its device: the reduction of :func:`cmul_max` without the product,
    one read.  Bit-equal to :func:`power_max_ref`."""
    _max_args(A, None)
    if not _on_cuda(A):
        return power_max_ref(A)
    return _max_launch("power_max_launch", A, None, None, None)


# ---------------------------------------------------------------------------
# the pencil FFT's local passes between its all-to-alls
# ---------------------------------------------------------------------------
def pencil_dft_ref(z: torch.Tensor, W: torch.Tensor,
                   tw=None) -> torch.Tensor:
    """Plain version, the composed operations of the transform: without
    ``tw`` the einsum ``W[n, k] z[k, ..., c]``; with it the einsum into
    ``(..., k, c)``, :func:`cmul_ref` by ``tw`` along the flattened
    ``(k, c)`` row, and the pack back to ``(P, ..., C)``."""
    if tw is None:
        return torch.einsum("nk,k...c->n...c", W, z).contiguous()
    P, C = z.shape[0], z.shape[-1]
    lead = z.shape[1:-1]
    y = torch.einsum("kn,n...c->...kc", W, z).reshape(lead + (P * C,))
    y = cmul_ref(y.contiguous(), tw)
    return y.reshape(lead + (P, C)).movedim(-2, 0).contiguous()


def pencil_dft(z: torch.Tensor, W: torch.Tensor, tw=None) -> torch.Tensor:
    """The pencil FFT's P-point DFT over the rank axis, with its twiddle:
    ``y[k, ..., c] = tw[k*C + c] * sum_n W[k, n] * z[n, ..., c]``.

    ``z``: complex64 ``(P, ..., C)``, the all-to-all's output; ``W``:
    complex64 ``(P, P)``; ``tw``: complex64 ``(P*C,)`` or None (no
    twiddle).  Returns a new ``(P, ..., C)`` tensor, the layout the next
    all-to-all sends.  The kernel sums each component with fused
    multiply-adds in ``n`` order and rounds the twiddle product as
    :func:`cmul`; it can differ from :func:`pencil_dft_ref` (the einsum)
    only in the order of those roundings (on an H100 the two agree bit for
    bit)."""
    _check(z, "z", torch.complex64)
    _check(W, "W", torch.complex64)
    P = W.shape[0] if W.ndim == 2 else 0
    if W.shape != (P, P) or P < 1 or z.ndim < 2 or z.shape[0] != P:
        raise ValueError(f"pencil_dft takes W (P, P) and z (P, ..., C), got "
                         f"{tuple(W.shape)} and {tuple(z.shape)}")
    C = z.shape[-1]
    if tw is not None:
        _check(tw, "tw", torch.complex64)
        if tw.shape != (P * C,):
            raise ValueError(f"pencil_dft takes a twiddle of P*C = {P * C} "
                             f"samples, got {tuple(tw.shape)}")
    if not _on_cuda(z, W, *(() if tw is None else (tw,))):
        return pencil_dft_ref(z, W, tw)
    from . import _build
    lib = _build.load_library("pencil")
    y = torch.empty_like(z)
    if z.numel():
        with torch.cuda.device(z.device):
            err = lib.pencil_dft_launch(
                z.data_ptr(), W.data_ptr(),
                None if tw is None else tw.data_ptr(), y.data_ptr(), P,
                z.numel() // (P * C), C, _raw_stream(z.device.index))
        _build.check(lib, err, "pencil_dft")
        LAUNCHES["pencil"] += 1
    return y


def pencil_twiddle_pack_ref(u: torch.Tensor, tw: torch.Tensor,
                            P: int) -> torch.Tensor:
    """Plain version: :func:`cmul_ref` by ``tw``, then the pack of the
    last axis's ``P`` blocks to the front."""
    lead, C = u.shape[:-1], u.shape[-1] // P
    return cmul_ref(u, tw).reshape(lead + (P, C)).movedim(-2, 0).contiguous()


def pencil_twiddle_pack(u: torch.Tensor, tw: torch.Tensor,
                        P: int) -> torch.Tensor:
    """The inverse pencil FFT's twiddle and pack:
    ``out[p, ..., c] = u[..., p*C + c] * tw[p*C + c]``.

    ``u``: complex64 ``(..., B)`` with ``B % P == 0``, the inverse FFT's
    output; ``tw``: complex64 ``(B,)``.  Returns a new ``(P, ..., B/P)``
    tensor, the layout the all-to-all sends.  The product rounds as
    :func:`cmul`, so the result is bit-equal to
    :func:`pencil_twiddle_pack_ref` on the card."""
    _check(u, "u", torch.complex64)
    _check(tw, "tw", torch.complex64)
    P = int(P)
    if u.ndim < 1 or P < 1 or u.shape[-1] % P or tw.shape != u.shape[-1:]:
        raise ValueError(
            f"pencil_twiddle_pack takes u (..., B) with B divisible by P = "
            f"{P} and a twiddle of B, got {tuple(u.shape)} and "
            f"{tuple(tw.shape)}")
    if not _on_cuda(u, tw):
        return pencil_twiddle_pack_ref(u, tw, P)
    from . import _build
    lib = _build.load_library("pencil")
    C = u.shape[-1] // P
    out = torch.empty((P,) + u.shape[:-1] + (C,), dtype=u.dtype,
                      device=u.device)
    if u.numel():
        with torch.cuda.device(u.device):
            err = lib.pencil_twiddle_pack_launch(
                u.data_ptr(), tw.data_ptr(), out.data_ptr(), P,
                u.numel() // u.shape[-1], C, _raw_stream(u.device.index))
        _build.check(lib, err, "pencil_twiddle_pack")
        LAUNCHES["pencil"] += 1
    return out


# ---------------------------------------------------------------------------
# histograms: the 2-D table of index pairs, and its row-batched form
# ---------------------------------------------------------------------------
#: most rows (or table rows ``nt``) one launch takes: rows times tiles is the
#: grid's second dimension (``kMaxTiles`` in csrc/histogram2d.cu)
HIST_MAX_ROWS = 65535 // 16

#: the kernels' u32 scratch per (device index, stream): all zero between
#: launches (the last block of a launch zeroes what the launch used)
_hist_scratch: dict = {}


def histogram2d_ref(t_idx: torch.Tensor, y_idx: torch.Tensor, nt: int,
                    ny: int) -> torch.Tensor:
    """Plain version: ``bincount`` over ``t*ny + y`` on the in-range pairs."""
    ok = (t_idx >= 0) & (t_idx < nt) & (y_idx >= 0) & (y_idx < ny)
    flat = t_idx[ok].to(torch.int64) * ny + y_idx[ok].to(torch.int64)
    return torch.bincount(flat, minlength=nt * ny).to(
        torch.float32).reshape(nt, ny)


def histogram_rows_ref(y_idx: torch.Tensor, ny: int) -> torch.Tensor:
    """Plain version of :func:`histogram_rows`: ``bincount`` over
    ``row*ny + y`` on the in-range samples."""
    nrow = y_idx.shape[0]
    ok = (y_idx >= 0) & (y_idx < ny)
    row = torch.arange(nrow, device=y_idx.device).unsqueeze(1).expand_as(
        y_idx)
    flat = row[ok] * ny + y_idx[ok].to(torch.int64)
    return torch.bincount(flat, minlength=nrow * ny).to(
        torch.float32).reshape(nrow, ny)


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a pointer value.
    ``torch.cuda.current_stream`` builds a ``Stream`` object on every call,
    several microseconds of a launch that takes about ten; torch's own raw
    accessor (the one its Triton backend launches with) is taken where this
    torch has it."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _hist_launch(rows: bool, t_idx, y_idx, nt: int, ny: int) -> torch.Tensor:
    """Launch the histogram kernel family on CUDA tensors: one output
    allocation, the cached scratch, the row count ``nt`` of ``y_idx`` or the
    pairs ``(t_idx, y_idx)``."""
    from . import _build
    lib = _build.load_library("histogram2d")
    dev = y_idx.device
    stream = _raw_stream(dev.index)
    need = _hist_scratch_len(rows, nt, ny)
    # allocated on the stream that will use it
    scratch = _hist_scratch_for(dev, stream, need)
    out = torch.empty((nt, ny), dtype=torch.float32, device=dev)
    sp, sn = (scratch.data_ptr(), scratch.numel()) if need else (None, 0)
    if rows:
        err = lib.histogram_rows_launch(y_idx.data_ptr(), nt,
                                        y_idx.shape[1], ny, sp, sn,
                                        out.data_ptr(), dev.index, stream)
    else:
        err = lib.histogram2d_launch(t_idx.data_ptr(), y_idx.data_ptr(),
                                     y_idx.numel(), nt, ny, sp, sn,
                                     out.data_ptr(), dev.index, stream)
    if err:
        # a refused or failed launch may leave sums behind
        _hist_scratch.pop((dev.index, stream), None)
        _build.check(lib, err, "histogram2d")
    LAUNCHES["histogram2d"] += 1
    return out


def _hist_scratch_for(dev: torch.device, stream: int, need: int):
    """The zeroed scratch of the histogram launches on ``stream`` (a raw
    stream pointer) of ``dev``, made or grown to ``need`` elements on the
    current stream; None where the launch needs none."""
    scratch = _hist_scratch.get((dev.index, stream))
    if need and (scratch is None or scratch.numel() < need):
        with torch.cuda.device(dev):
            scratch = torch.zeros(max(need, 2**16), dtype=torch.int32,
                                  device=dev)
        _hist_scratch[(dev.index, stream)] = scratch
    return scratch


def histogram_rows_scratch(nrow: int, ny: int, device,
                           stream: "torch.cuda.Stream"):
    """The scratch that a :func:`histogram_rows` launch of ``nrow`` rows
    and ``ny`` bins on ``stream`` will use, made now (None where it needs
    none).  For a CUDA graph captured on ``stream``: it is made on the
    current stream, where the graph's replays run, and the graph holds
    it."""
    nrow, ny = _hist_shape(nrow, ny)
    return _hist_scratch_for(torch.device(device), stream.cuda_stream,
                             _hist_scratch_len(True, nrow, ny))


@functools.lru_cache(maxsize=None)
def _hist_scratch_len(rows: bool, nt: int, ny: int) -> int:
    from . import _build
    return int(_build.load_library("histogram2d").histogram_scratch_len(
        int(rows), nt, ny))


def _hist_shape(nt: int, ny: int) -> tuple:
    nt, ny = int(nt), int(ny)
    if nt < 1 or ny < 1 or nt * ny >= 2**31:
        raise ValueError(f"bad histogram shape ({nt}, {ny})")
    return nt, ny


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
    nt, ny = _hist_shape(nt, ny)
    if not _on_cuda(t_idx, y_idx):
        return histogram2d_ref(t_idx, y_idx, nt, ny)
    return _hist_launch(False, t_idx, y_idx, nt, ny)


def histogram_rows(y_idx: torch.Tensor, ny: int) -> torch.Tensor:
    """Row-batched histogram: ``counts[c, j] = #{k : y_idx[c, k] == j}`` as
    float32 ``(C, ny)`` for int32 ``y_idx`` of shape ``(C, n)``, each row
    counted on its own (the JAX package's ``vmap`` over a 1-D scatter).
    Samples out of range (e.g. -1 for a masked sample) are dropped; counts
    are exact integers (up to 2^24 per bin).  The same kernel family as
    :func:`histogram2d` with the row taken from the block index, so no
    row-index array is read; it counts as a ``histogram2d`` launch."""
    _check(y_idx, "y_idx", torch.int32)
    if y_idx.ndim != 2 or not 1 <= y_idx.shape[0] <= HIST_MAX_ROWS:
        raise ValueError(
            f"y_idx must be (C, n) with 1 <= C <= {HIST_MAX_ROWS}, got "
            f"{tuple(y_idx.shape)}")
    nrow, ny = _hist_shape(y_idx.shape[0], ny)
    if not _on_cuda(y_idx):
        return histogram_rows_ref(y_idx, ny)
    return _hist_launch(True, None, y_idx, nrow, ny)


# ---------------------------------------------------------------------------
# ADC quantiser
# ---------------------------------------------------------------------------
def _adc_grid(lo: float, hi: float, nbits: int):
    """``(lo, step, levels)`` as the Pallas kernel takes them: the step is
    computed in float64 and rounded to float32 once."""
    levels = 2 ** int(nbits)
    return (np.float32(lo), np.float32((hi - lo) / (levels - 1)), levels)


def adc_quantize_ref(x: torch.Tensor, lo: float, hi: float, nbits: int,
                     stochastic: bool = False, seed: int = 0) -> torch.Tensor:
    """Plain version of kernel mode: ``q = (x - lo)/step``, half-up
    ``floor(q + 0.5)`` (or ``floor(q + u)`` with ``u`` uniform from a
    ``torch.Generator`` seeded with ``seed``), clip to ``[0, 2^n - 1]``,
    ``lo + q*step``."""
    lo32, step, levels = _adc_grid(lo, hi, nbits)
    # a tensor divisor: torch on CUDA turns division by a Python scalar into
    # a multiplication by its reciprocal, which rounds differently
    q = (x - float(lo32)) / torch.tensor(step, device=x.device)
    if stochastic:
        g = torch.Generator(device=x.device).manual_seed(int(seed))
        q = torch.floor(q + torch.rand(x.shape, generator=g, device=x.device,
                                       dtype=torch.float32))
    else:
        q = torch.floor(q + 0.5)
    return torch.clamp(q, 0.0, float(levels - 1)) * float(step) + float(lo32)


def adc_quantize(x: torch.Tensor, lo: float, hi: float, nbits: int,
                 stochastic: bool = False, seed: int = 0) -> torch.Tensor:
    """Uniform ``nbits`` quantiser over ``[lo, hi]``, the function of the
    TPU kernel ``pallas_kernels.adc_quantize``: round half up, or
    stochastic rounding dithered by Philox4x32-10 keyed by ``seed`` (each
    sample its own dither; the plain version draws from a
    ``torch.Generator``, so the two agree in distribution only).  Clips to
    the range.  ``x``: contiguous float32."""
    _check(x, "x", torch.float32)
    if not 1 <= int(nbits) <= 24:
        raise ValueError(f"nbits must be in [1, 24], got {nbits}")
    if not _on_cuda(x):
        return adc_quantize_ref(x, lo, hi, nbits, stochastic, seed)
    from . import _build
    lib = _build.load_library("adc_quantize")
    lo32, step, levels = _adc_grid(lo, hi, nbits)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.adc_kernel_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_longlong(x.numel()), ctypes.c_float(lo32),
            ctypes.c_float(step), ctypes.c_int(levels),
            ctypes.c_int(int(stochastic)),
            ctypes.c_ulonglong(int(seed) % 2**64),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, err, "adc_quantize")
    LAUNCHES["adc_quantize"] += 1
    return y


def adc_quantize_link_ref(v: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of link mode, in ``link._adc_quantize``'s order:
    ``code = round((v - lo)/(hi - lo)*nq)`` half to even, no clip,
    ``code/nq*(hi - lo) + lo``."""
    nq = torch.tensor(np.float32(2 ** int(bits) - 1), device=v.device)
    # nq as a tensor: torch on CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which rounds differently
    code = torch.round((v - lo) / (hi - lo) * nq)
    return code / nq * (hi - lo) + lo


def adc_quantize_link(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """The fused link's ADC: ``bits``-bit uniform quantisation of ``v`` on
    the range ``[lo, hi]`` given as 0-d float32 tensors on ``v``'s device
    (read by the kernel from device memory, never brought to the host).
    Rounds half to even and does not clip: samples outside the range
    extrapolate.  Bit-equal to :func:`adc_quantize_link_ref`."""
    _check(v, "v", torch.float32)
    for name, t in (("lo", lo), ("hi", hi)):
        _check(t, name, torch.float32)
        if t.ndim != 0:
            raise ValueError(f"{name} must be a 0-d tensor")
    if not 1 <= int(bits) <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    if not _on_cuda(v, lo, hi):
        return adc_quantize_link_ref(v, lo, hi, bits)
    from . import _build
    lib = _build.load_library("adc_quantize")
    y = torch.empty_like(v)
    with torch.cuda.device(v.device):
        err = lib.adc_link_launch(
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_longlong(v.numel()), ctypes.c_void_p(lo.data_ptr()),
            ctypes.c_void_p(hi.data_ptr()),
            ctypes.c_float(np.float32(2 ** int(bits) - 1)),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, err, "adc_quantize")
    LAUNCHES["adc_quantize"] += 1
    return y


# ---------------------------------------------------------------------------
# causal FIR filter
# ---------------------------------------------------------------------------
#: most taps the ``fir_filter`` kernel takes (two windows and the taps fit one
#: CTA's shared memory; ``kMaxTaps`` in csrc/fir_filter.cu)
FIR_MAX_TAPS = 8192


def fir_filter_ref(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version: ``conv1d`` over the flipped taps with ``taps - 1``
    zeros of left padding, in full float32 (cuDNN's TF32 path is switched
    off for the call)."""
    xp = torch.nn.functional.pad(x.reshape(1, 1, -1), (h.numel() - 1, 0))
    w = torch.flip(h, (0,)).reshape(1, 1, -1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.functional.conv1d(xp, w).reshape(-1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def fir_filter(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR ``y[n] = sum_{j<taps} h[j] x[n-j]`` with ``x[<0] = 0`` and
    ``len(y) = len(x)``, the function of the TPU kernel
    ``pallas_kernels.fir_filter``.  ``x`` and ``h``: contiguous 1-D float32
    on one device, ``1 <= taps <= FIR_MAX_TAPS``; the kernel sums each
    output in float32 in tap order."""
    _check(x, "x", torch.float32)
    _check(h, "h", torch.float32)
    if x.ndim != 1 or h.ndim != 1:
        raise ValueError(f"x and h must be 1-D, got {tuple(x.shape)} and "
                         f"{tuple(h.shape)}")
    if not 1 <= h.numel() <= FIR_MAX_TAPS:
        raise ValueError(f"fir_filter takes 1 to {FIR_MAX_TAPS} taps, got "
                         f"{h.numel()}")
    if not _on_cuda(x, h):
        return fir_filter_ref(x, h)
    from . import _build
    lib = _build.load_library("fir_filter")
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            err = lib.fir_launch(
                ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(h.data_ptr()),
                ctypes.c_void_p(y.data_ptr()), ctypes.c_longlong(x.numel()),
                ctypes.c_int(h.numel()),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(lib, err, "fir_filter")
        LAUNCHES["fir_filter"] += 1
    return y


# ---------------------------------------------------------------------------
# fiber Bragg grating: coupled-mode RK4
# ---------------------------------------------------------------------------
def _fbg_args(delta, s, k, p0, p1, p2, zs, n_steps: int) -> int:
    for name, t in (("delta", delta), ("s", s), ("k", k), ("p0", p0),
                    ("p1", p1), ("p2", p2), ("zs", zs)):
        _check(t, name, torch.float32)
        if t.ndim != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    if not delta.shape == s.shape == k.shape:
        raise ValueError(
            f"delta, s and k must have one length, got {tuple(delta.shape)}, "
            f"{tuple(s.shape)} and {tuple(k.shape)}")
    n_steps = int(n_steps)
    if n_steps < 1 or any(t.numel() != n_steps for t in (p0, p1, p2, zs)):
        raise ValueError(f"p0, p1, p2 and zs must hold n_steps = {n_steps} "
                         f"values")
    return n_steps


def _fbg_chirp(F, zs: torch.Tensor, n_steps: int) -> tuple:
    """The chirp terms of each RK4 step, the same for every bin: ``F*z``,
    ``F*(z + dz/2)`` and ``F*(z + dz)``, float32 on ``zs``'s device, rounded
    as the JAX scan rounds them (``dz/2`` and ``dz`` rounded once, then a
    float32 sum and product)."""
    dz = -1.0 / n_steps
    F32 = float(np.float32(F))
    return tuple(F32 * (zs + float(np.float32(off)))
                 for off in (0.0, dz / 2, dz))


def fbg_rk4_ref(delta, s, k, F, p0, p1, p2, zs, n_steps: int) -> tuple:
    """Plain version: the JAX package's scan body (``devices._fbg_rk4``) as
    a loop of complex64 tensor operations, with its float32 constants
    (``dz/2``, ``dz/6`` and the chirp terms of :func:`_fbg_chirp`)."""
    n_steps = _fbg_args(delta, s, k, p0, p1, p2, zs, n_steps)
    dz = -1.0 / n_steps
    delta, s, k = (t.to(torch.complex64) for t in (delta, s, k))
    grid = zip(*(t.cpu().tolist()
                 for t in (*_fbg_chirp(F, zs, n_steps), p0, p1, p2)))

    def deriv(R, S, Fz, p):
        shat = delta + s * p - Fz
        kk = k * p
        return 1j * (shat * R + kk * S), -1j * (shat * S + kk * R)

    R = torch.ones_like(delta)
    S = torch.zeros_like(delta)
    for Fa, Fb, Fc, pa, pb, pc in grid:
        k1R, k1S = deriv(R, S, Fa, pa)
        k2R, k2S = deriv(R + dz / 2 * k1R, S + dz / 2 * k1S, Fb, pb)
        k3R, k3S = deriv(R + dz / 2 * k2R, S + dz / 2 * k2S, Fb, pb)
        k4R, k4S = deriv(R + dz * k3R, S + dz * k3S, Fc, pc)
        R = R + dz / 6 * (k1R + 2 * k2R + 2 * k3R + k4R)
        S = S + dz / 6 * (k1S + 2 * k2S + 2 * k3S + k4S)
    return R, S


def fbg_rk4(delta: torch.Tensor, s: torch.Tensor, k: torch.Tensor, F,
            p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
            zs: torch.Tensor, n_steps: int) -> tuple:
    """Coupled-mode equations of a fiber Bragg grating, ``R' = i(shat R +
    kk S)``, ``S' = -i(shat S + kk R)`` with ``shat = delta + s p - F z``
    and ``kk = k p``, integrated from ``z = 1/2`` to ``-1/2`` by ``n_steps``
    fixed RK4 steps from ``R = 1, S = 0``, every frequency bin at once: the
    function of the JAX package's ``devices._fbg_rk4``.

    ``delta``, ``s``, ``k``: the detuning, DC self-coupling and AC coupling
    of each bin, real, float32 ``(n,)``; ``F``: the chirp; ``zs``: the
    step starts and ``p0``, ``p1``, ``p2``: the apodization at ``z``,
    ``z + dz/2`` and ``z + dz``, float32 ``(n_steps,)``, on the device of
    ``delta``.  Returns ``(R, S)``, complex64 ``(n,)``; the reflection
    response is ``S/R``."""
    n_steps = _fbg_args(delta, s, k, p0, p1, p2, zs, n_steps)
    if not _on_cuda(delta, s, k, p0, p1, p2, zs):
        return fbg_rk4_ref(delta, s, k, F, p0, p1, p2, zs, n_steps)
    from . import _build
    lib = _build.load_library("fbg_rk4")
    R = torch.empty(delta.shape, dtype=torch.complex64, device=delta.device)
    S = torch.empty_like(R)
    dz = -1.0 / n_steps
    if delta.numel():
        with torch.cuda.device(delta.device):
            fa, fb, fc = _fbg_chirp(F, zs, n_steps)
            err = lib.fbg_rk4_launch(
                *(ctypes.c_void_p(t.data_ptr())
                  for t in (delta, s, k, p0, p1, p2, fa, fb, fc)),
                ctypes.c_int(n_steps), ctypes.c_float(np.float32(dz)),
                ctypes.c_float(np.float32(dz / 2)),
                ctypes.c_float(np.float32(dz / 6)),
                ctypes.c_void_p(R.data_ptr()), ctypes.c_void_p(S.data_ptr()),
                ctypes.c_longlong(delta.numel()),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(lib, err, "fbg_rk4")
        LAUNCHES["fbg_rk4"] += 1
    return R, S
