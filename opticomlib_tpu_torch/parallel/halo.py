"""Halo-exchange primitives and halo-width derivation for the sharded SSFM
(port of ``opticomlib_tpu.parallel.halo``).

The dispersion operator ``exp(i*beta2/2*w^2*h)`` is an all-pass chirp whose
*group delay* is bounded on a band-limited signal:

    tau(w) = (beta2*h) * w  + (beta3*h)/2 * w^2,   |w| <= pi*fs

so after one linear step of size ``h`` no signal energy moves further than

    T_max = |beta2*h| * pi*fs  +  |beta3*h|/2 * (pi*fs)^2      [seconds]

from its original position (stationary-phase bound).  That makes blockwise
overlap-save exact up to spectral-leakage terms: each rank processes its
block plus ``H = ceil(T_max * fs * safety)`` halo samples from its ring
neighbours, applies the operator with a local FFT, and discards the halos.
Ring (wrap-around) neighbours reproduce the *circular* boundary semantics
of the single-FFT linear step (reference devices.py:1179), so the sharded
result converges to the single-device result as the halo grows.

The exchange is one batch of point-to-point sends and receives on the
'time' group: the trailing ``H`` samples travel to the right neighbour, the
leading ``H`` to the left.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["halo_width", "exchange_halos", "pad_block_operator"]


def halo_width(h_km: float, beta2: float, beta3: float, fs: float,
               safety: float = 4.0, minimum: int = 8) -> int:
    """Number of halo samples needed per side for one linear step of
    ``h_km`` km (beta2 [ps^2/km], beta3 [ps^3/km], fs [Hz])."""
    fs_thz = fs * 1e-12  # samples per ps
    w_max = math.pi * fs_thz  # rad/ps at band edge
    t_max_ps = (abs(beta2 * h_km) * w_max
                + abs(beta3 * h_km) / 2 * w_max**2)
    return max(minimum, int(math.ceil(t_max_ps * fs_thz * safety)))


def exchange_halos(x: torch.Tensor, H: int, axis) -> torch.Tensor:
    """Gather ``H`` trailing samples from the left ring neighbour and ``H``
    leading samples from the right ring neighbour of the sharded last axis.

    ``x``: this rank's block (complex64, last axis = time).  ``axis``: the
    mesh's time axis (``mesh.axis("time")``: ``group``, ``size``, ``index``
    and the global ``ranks`` along it).  Returns the padded block
    ``[left_halo | x | right_halo]``.  A rank that is its own neighbour (an
    axis of one rank) wraps around itself, with nothing sent.
    """
    tail, head = x[..., -H:], x[..., :H]
    if axis.size == 1:
        return torch.cat([tail, x, head], dim=-1)
    right = axis.ranks[(axis.index + 1) % axis.size]
    left = axis.ranks[(axis.index - 1) % axis.size]
    # complex64 travels as its float32 (re, im) pairs: NCCL's point-to-point
    # calls take no complex type
    send_r = torch.view_as_real(tail.contiguous())
    send_l = torch.view_as_real(head.contiguous())
    recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
    ops = [dist.P2POp(dist.isend, send_r, right, axis.group),
           dist.P2POp(dist.isend, send_l, left, axis.group),
           dist.P2POp(dist.irecv, recv_l, left, axis.group),
           dist.P2POp(dist.irecv, recv_r, right, axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([torch.view_as_complex(recv_l), x,
                      torch.view_as_complex(recv_r)], dim=-1)


def pad_block_operator(block_len: int, H: int, fs: float, alpha_db_km: float,
                       beta2: float, beta3: float) -> np.ndarray:
    """Linear operator D(w) sampled on the padded-block FFT grid
    (length ``block_len + 2H``), natural FFT order, complex64."""
    from ..ops.ssfm import linear_operator

    n = block_len + 2 * H
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    return linear_operator(w, alpha_db_km, beta2, beta3)
