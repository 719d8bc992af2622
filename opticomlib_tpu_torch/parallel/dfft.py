"""Exact distributed FFT over a sharded sample axis (pencil / 4-step
decomposition; port of ``opticomlib_tpu.parallel.dfft``).

The sharded SSFM needs a *global* spectral multiply per linear step.  The
overlap-save path (:mod:`opticomlib_tpu_torch.parallel.halo`) is
approximate: its error decays only ~1/H^2 because the dispersion operator's
band-edge discontinuity rings in the time domain.  This module is the exact
alternative: Bailey's four-step FFT across the ranks of the 'time' axis,
with two ``all_to_all_single`` collectives per transform.

Decomposition (N = P * B, rank p holds the contiguous block
``x[p*B : (p+1)*B]``; C = B / P):

  X[k1 + P*k2] = sum_{n2} e^{-2 pi i k1 n2 / N} e^{-2 pi i k2 n2 / B}
                   * sum_{n1} x[n1*B + n2] e^{-2 pi i n1 k1 / P}

so the chain is: all-to-all transpose (bring all n1 local for a slice of
n2) -> P-point DFT over the rank axis as a small ``einsum`` -> twiddle
(``kernels.cmul``) -> all-to-all transpose -> local B-point FFT
(``torch.fft``).  The spectrum comes out in the *strided* layout: rank q
holds ``X[q + P*k2]`` for k2 in [0, B).  That layout is fine for SSFM (the
linear operator is sampled at the strided frequencies,
:func:`strided_w_grid`) and the inverse transform undoes the permutation,
returning the natural block layout.

Constraint: B must be divisible by P (i.e. N divisible by P^2).

The DFT matrices and twiddles of a (P, B, rank, device) are built once, in
float64, and kept (:data:`_consts`); :data:`BUILDS` counts the builds.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels

__all__ = ["pencil_fft", "pencil_ifft", "strided_w_grid", "strided_k_local"]

_2PI = 2.0 * np.pi

#: (P, B, q, device) -> (W forward, W inverse / P, forward twiddle (B,),
#: inverse twiddle (B,)), least recently used first
_consts: "OrderedDict" = OrderedDict()
_CONSTS_MAX = 32
#: how many times the constants of a transform were built (not found kept)
BUILDS = 0


def strided_k_local(q: int, P: int, B: int) -> np.ndarray:
    """Global FFT bin indices held by rank ``q`` after :func:`pencil_fft`:
    ``k = q + P*k2``, k2 in [0, B)."""
    return q + P * np.arange(B, dtype=np.int64)


def strided_w_grid(q: int, P: int, B: int, fs: float,
                   device=None) -> torch.Tensor:
    """Angular frequencies [rad/s] of the local spectrum slice on rank
    ``q`` (fftfreq convention: bins >= N/2 wrap to negative): a float32
    tensor on ``device`` (default the CPU), computed in the JAX function's
    float32 operations and order: the wrapped bin index over ``N``, times
    ``fs``, times 2*pi."""
    N = P * B
    k = q + P * torch.arange(B, dtype=torch.int64, device=device)
    k = torch.where(k < N - N // 2, k, k - N).to(torch.float32)
    # a tensor divisor: torch on CUDA turns division by a Python scalar into
    # a multiplication by its reciprocal, which rounds differently
    f = k / torch.tensor(N, dtype=torch.float32, device=device) * fs
    return f * _2PI


def strided_dispersion_phase(q: int, P: int, B: int, fs: float,
                             beta_2: float, beta_3: float,
                             device=None) -> torch.Tensor:
    """Dispersion phase rate [rad/km] on rank ``q``'s strided bins, float32
    as the JAX sharded solvers evaluate it in-graph:
    ``beta_2/2*w**2 + beta_3/6*w**3`` with ``w`` in rad/ps."""
    w = strided_w_grid(q, P, B, fs, device) * 1e-12
    w2 = w * w
    return w2 * (beta_2 / 2) + w2 * w * (beta_3 / 6)


def _transform_consts(P: int, B: int, q: int, device: torch.device):
    global BUILDS
    key = (P, B, q, str(device))
    hit = _consts.get(key)
    if hit is not None:
        _consts.move_to_end(key)
        return hit
    BUILDS += 1
    C, N = B // P, P * B
    k = torch.arange(P, dtype=torch.float64, device=device)
    ang = (_2PI / P) * torch.outer(k, k)
    one = torch.ones((), dtype=torch.float64, device=device)
    W_f = torch.polar(one.expand_as(ang), -ang).to(torch.complex64)
    W_i = (torch.polar(one.expand_as(ang), ang) / P).to(torch.complex64)
    # forward: e^{-2 pi i k1 n2 / N} at [k1, c], n2 = q*C + c, flattened to
    # the (P*C,) row the field has in its (..., k1, c) layout; the integer
    # product is reduced mod N before it becomes an angle
    k1 = torch.arange(P, dtype=torch.int64, device=device)[:, None]
    n2 = (q * C + torch.arange(C, dtype=torch.int64, device=device))[None, :]
    a_f = ((k1 * n2) % N).to(torch.float64).reshape(-1) * (_2PI / N)
    tw_f = torch.polar(one.expand_as(a_f), -a_f).to(torch.complex64)
    # inverse: e^{+2 pi i q n2 / N}, n2 in [0, B)
    a_i = ((q * torch.arange(B, dtype=torch.int64, device=device)) % N).to(
        torch.float64) * (_2PI / N)
    tw_i = torch.polar(one.expand_as(a_i), a_i).to(torch.complex64)
    out = (W_f, W_i, tw_f.contiguous(), tw_i.contiguous())
    _consts[key] = out
    while len(_consts) > _CONSTS_MAX:
        _consts.popitem(last=False)
    return out


def _all_to_all(z: torch.Tensor, axis) -> torch.Tensor:
    """``out[p] = z on rank p [this rank's index]`` along dim 0 (size P).
    complex64 is sent as its float32 (re, im) pairs, which every backend
    takes (gloo takes complex64 as it is; NCCL has no complex type)."""
    z = torch.view_as_real(z.contiguous())
    out = torch.empty_like(z)
    dist.all_to_all_single(out, z, group=axis.group)
    return torch.view_as_complex(out)


def pencil_fft(x: torch.Tensor, axis) -> torch.Tensor:
    """Distributed FFT of a block-sharded last-axis signal.

    ``x``: this rank's block, complex64, shape (..., B) with B % P == 0.
    ``axis``: the mesh's time axis (``mesh.axis("time")``), P ranks.
    Returns the local strided spectrum slice, shape (..., B): element k2 is
    global bin ``q + P*k2``.  Every rank of the axis must call it.
    """
    P, q = axis.size, axis.index
    B = x.shape[-1]
    C = B // P
    lead = x.shape[:-1]
    W_f, _, tw_f, _ = _transform_consts(P, B, q, x.device)

    # 1) transpose: bring all n1 (rank axis) local for n2 = q*C + c
    z = _all_to_all(x.reshape(lead + (P, C)).movedim(-2, 0), axis)
    # z[n1, ..., c] = x_global[n1*B + q*C + c]

    # 2) P-point DFT over the n1 axis, 3) twiddle e^{-2 pi i k1 n2 / N}
    y = torch.einsum("kn,n...c->...kc", W_f, z).reshape(lead + (B,))
    y = kernels.cmul(y.contiguous(), tw_f)

    # 4) transpose: bring all n2 local for k1 = q
    y = _all_to_all(y.reshape(lead + (P, C)).movedim(-2, 0), axis)
    # y[p, ..., c] corresponds to n2 = p*C + c, k1 = q
    y = y.movedim(0, -2).reshape(lead + (B,))

    # 5) local B-point FFT over n2 -> X[q + P*k2]
    return torch.fft.fft(y, dim=-1)


def pencil_ifft(X: torch.Tensor, axis) -> torch.Tensor:
    """Inverse of :func:`pencil_fft`: strided spectrum slice back to the
    natural block layout."""
    P, q = axis.size, axis.index
    B = X.shape[-1]
    C = B // P
    lead = X.shape[:-1]
    _, W_i, _, tw_i = _transform_consts(P, B, q, X.device)

    # 5') local inverse FFT over k2: u[n2], k1 = q; 3') conjugate twiddle
    u = kernels.cmul(torch.fft.ifft(X, dim=-1).contiguous(), tw_i)

    # 4') transpose: redistribute n2 slices, gather all k1
    u = _all_to_all(u.reshape(lead + (P, C)).movedim(-2, 0), axis)
    # u[k1, ..., c], local n2 = q*C + c

    # 2') inverse P-point DFT over k1: r[n1, ..., c] = x[n1*B + q*C + c]
    r = torch.einsum("nk,k...c->n...c", W_i, u)

    # 1') transpose back to contiguous blocks
    r = _all_to_all(r, axis)
    return r.movedim(0, -2).reshape(lead + (B,)).contiguous()
