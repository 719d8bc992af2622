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

:func:`signal_from_jax` and :func:`gv_from_jax` carry the staged API's
state across: a JAX ``BinarySequence`` / ``ElectricalSignal`` /
``OpticalSignal`` (NumPy or JAX leaves) becomes the port's, dtype, ``NULL``
noise and polarizations kept, and the JAX ``gv``'s parameters become the
port's.  Both read the JAX objects by their attributes, so the port imports
nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from . import params, signals

__all__ = ["consts_from_jax", "signal_from_jax", "gv_from_jax"]


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


def signal_from_jax(sig, device="cpu"):
    """The port's counterpart of a JAX ``BinarySequence`` (a host copy of
    its bits), ``ElectricalSignal`` or ``OpticalSignal`` (its leaves as
    tensors on ``device``, dtype kept; ``NULL`` noise stays ``NULL``)."""
    kind = type(sig).__name__
    if kind == "BinarySequence":
        return signals.BinarySequence(np.asarray(sig.data))
    if kind not in ("ElectricalSignal", "OpticalSignal"):
        raise TypeError(f"not a JAX signal: {type(sig)!r}")
    device = params.check_device(device)

    def leaf(x):
        if type(x).__name__ == "NULLType":
            return signals.NULL
        return torch.as_tensor(np.array(x), device=device)

    if kind == "OpticalSignal":
        out = signals.OpticalSignal(leaf(sig.signal), leaf(sig.noise),
                                    n_pol=int(sig.n_pol))
    else:
        out = signals.ElectricalSignal(leaf(sig.signal), leaf(sig.noise))
    out.execution_time = float(getattr(sig, "execution_time", 0.0))
    return out


def gv_from_jax(gv):
    """Set the port's ``gv`` to the parameters of the JAX ``gv`` (``sps``,
    ``R``, ``fs``, ``N``, ``wavelength``); its device and extras stay.
    Returns the port's ``gv``."""
    p = gv.params
    params.gv.params = params.SimParams(
        sps=int(p.sps), R=float(p.R), fs=float(p.fs), N=int(p.N),
        wavelength=float(p.wavelength))
    return params.gv
