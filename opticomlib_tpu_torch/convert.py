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
JAX program's own constants; with ``mesh=`` the same for the sharded
programs, each rank taking its block.  The pipelined program's constants
are its TX twin's, as in the JAX package:
``pipelined.load_consts(consts_from_jax(jax_pipelined.consts))``.

:func:`signal_from_jax` and :func:`gv_from_jax` carry the staged API's
state across: a JAX ``BinarySequence`` / ``ElectricalSignal`` /
``OpticalSignal`` (NumPy or JAX leaves) becomes the port's, dtype, ``NULL``
noise and polarizations kept, and the JAX ``gv``'s parameters become the
port's.  Both read the JAX objects by their attributes, so the port imports
nothing of JAX.

:func:`sharded_from_jax` and :func:`sharded_to_jax` carry the sharded
solver's state across: the JAX package saves a sharded field as stacked
NumPy blocks ``re``, ``im`` with their global bounds
``extra["indices"]`` (a process's addressable shards; the payload of its
``shard=`` checkpoints), or as the whole field; the port's counterpart is a
:class:`~opticomlib_tpu_torch.parallel.fiber.ShardedField`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import params, signals

__all__ = ["consts_from_jax", "signal_from_jax", "gv_from_jax",
           "sharded_from_jax", "sharded_to_jax"]


def consts_from_jax(consts: dict, mesh=None, time_axis: str = "time") -> dict:
    """``{name: array}`` of the JAX program -> ``{name: CPU tensor}`` of
    the port (complex64 for recombined pairs, float32 otherwise).

    With ``mesh`` (a mesh of ranks with ``time_axis``), ``consts`` are those
    of the JAX ``ShardedLinkProgram`` (global arrays, the spectral ones in
    the pencil strided layout) and each array becomes this rank's block
    along the time axis, what the port's ``ShardedLinkProgram`` holds:
    ``prog.load_consts(consts_from_jax(jax_prog.consts, mesh))``."""
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
    if mesh is not None:
        axis = mesh.axis(time_axis)
        for name, t in out.items():
            B = t.shape[-1] // axis.size
            out[name] = t[..., axis.index * B:(axis.index + 1) * B].clone()
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


def _bounds(idx, shape):
    """JAX-side block bounds (``-1`` for an open stop) as explicit
    ``[start, stop]`` pairs."""
    return [[int(a), int(shape[d]) if b < 0 else int(b)]
            for d, (a, b) in enumerate(idx)]


def sharded_from_jax(re, im, indices, mesh, shape=None, wdm_axis="wdm"):
    """The port's ``ShardedField`` on ``mesh`` from a JAX-side payload.

    ``re``, ``im``: with ``indices`` (``extra["indices"]`` of a ``shard=``
    checkpoint: one ``[[start, stop], ...]`` a block, a stop of ``-1``
    meaning the end), the stacked blocks ``(k, ...)`` of the global field of
    ``shape``; this rank keeps the block with its own bounds and raises
    ``KeyError`` when the payload does not hold it.  With ``indices=None``,
    the whole field (a single-process checkpoint), of which this rank
    slices its block."""
    from .parallel.fiber import ShardedField, shard_waveform

    re, im = np.asarray(re, np.float32), np.asarray(im, np.float32)
    if indices is None:
        return shard_waveform((re + 1j * im).astype(np.complex64), mesh,
                              wdm_axis)
    if shape is None:
        raise ValueError("a payload of blocks needs the global shape")
    shape = tuple(int(s) for s in shape)
    layout = wdm_axis if len(shape) == 2 else None
    mine = ShardedField.block_indices(mesh, shape, layout)
    for k, idx in enumerate(indices):
        if _bounds(idx, shape) == mine:
            block = (re[k] + 1j * im[k]).astype(np.complex64)
            return ShardedField(torch.as_tensor(block, device=mesh.device),
                                mesh, shape, layout)
    raise KeyError(f"no block with bounds {mine} among {list(indices)}")


def sharded_to_jax(field):
    """``(re, im, {"indices": [...]})``: every block of a ``ShardedField``
    stacked ``(k, ...)`` in the order of their bounds, as float32 NumPy
    arrays, with the bounds in the JAX package's form (a dimension held
    whole is ``[0, -1]``): what its ``_assemble_from_host_shards`` rebuilds a
    global array from.  Gathers the field (a collective every rank of the
    mesh calls)."""
    from .parallel.fiber import ShardedField

    whole = field.gather()
    mesh, shape = field.mesh, field.shape
    rows_whole = len(shape) == 2 and not field.wdm_axis
    # rows held whole are the same block on every 'wdm' row: one is enough
    blocks = {}
    for idx in np.ndindex(*mesh.ranks.shape):
        bounds = ShardedField.block_indices(
            mesh, shape, field.wdm_axis, dict(zip(mesh.axis_names, idx)),
            field.time_axis)
        block = whole[tuple(slice(a, b) for a, b in bounds)]
        if rows_whole:
            bounds[0] = [0, -1]
        blocks[tuple(map(tuple, bounds))] = block
    keys = sorted(blocks)
    stacked = np.stack([blocks[k] for k in keys])
    return (np.ascontiguousarray(stacked.real),
            np.ascontiguousarray(stacked.imag),
            {"indices": [[list(pair) for pair in k] for k in keys]})
