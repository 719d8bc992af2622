"""Carry the JAX program's constants across to the port.

``opticomlib_tpu.link.LinkProgram.consts`` holds the spectral constants as
arrays, complex ones split into planar ``<name>_re`` / ``<name>_im`` float32
pairs (a workaround for complex transfers on the TPU runtime).
:func:`consts_from_jax` recombines those pairs into complex64 and passes the
real arrays (``phi_w_*``, ``phi_dm_*``, ``H2_bpf_*``, ``H2_pd``,
``df_phase``) through under their names, which are the names of
:class:`opticomlib_tpu_torch.link.LinkProgram`'s buffers (the two builders
number the spectral arrays with one counter in stage order), so
``prog.load_consts(consts_from_jax(jax_prog.consts))`` runs the port on the
JAX program's own constants.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["consts_from_jax"]


def consts_from_jax(consts: dict) -> dict:
    """``{name: array}`` of the JAX program -> ``{name: CPU tensor}`` of
    the port (complex64 for recombined pairs, float32 otherwise)."""
    out = {}
    for name, arr in consts.items():
        if name.endswith("_im"):
            if name[:-3] + "_re" not in consts:
                raise ValueError(f"{name} has no matching real part")
            continue
        if name.endswith("_re"):
            base = name[:-3]
            if base + "_im" not in consts:
                raise ValueError(f"{name} has no matching imaginary part")
            z = (np.asarray(arr, np.float32)
                 + 1j * np.asarray(consts[base + "_im"], np.float32))
            out[base] = torch.from_numpy(z.astype(np.complex64))
        else:
            out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out
