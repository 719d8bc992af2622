"""Sharded split-step Fourier propagation over a mesh of ranks (port of
``opticomlib_tpu.parallel.fiber`` to ``torch.distributed``).

The NLSE solve scales across cards by sharding

* the **time (sample) axis**: each rank owns a contiguous block of the
  waveform; the nonlinear (pointwise) kicks need no communication; the
  dispersion steps use either the exact pencil FFT
  (:mod:`opticomlib_tpu_torch.parallel.dfft`, two all-to-all a transform)
  or blockwise overlap-save with ring halo exchange
  (:mod:`opticomlib_tpu_torch.parallel.halo`);
* the **WDM channel axis**: independent channels, a leading dimension
  spread over the 'wdm' axis of the mesh.

One process is one rank and holds one block: where the JAX package returns
a global array, this one returns a :class:`ShardedField` (the rank's block,
the global shape and the mesh), which the next sharded call takes as it is
and which gathers to a host array on request (a collective).

Every rank takes the same steps: the adaptive loops decide on the host from
a value read back, and the all-reduce (``max|A|^2``, or the two error norms
of a step-doubling attempt in one tensor) runs on the device scalar before
the read-back, so every rank reads the same float32.

On each rank's block the kicks are ``kernels.nl_halfstep`` and the spectral
and twiddle products ``kernels.cmul``, as on one card.
"""
from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels
from ..ops.ssfm import (_first_step, _lin_factor, adaptive_h0, alpha_per_km,
                        dispersion_phase, max_power, ssfm_local_error_inside,
                        ssfm_o4_auto_inside, ssfm_o4_scan_inside,
                        ssfm_scan_inside, ssfm_step_schedule,
                        ssfm_while_inside)
from .dfft import pencil_fft, pencil_ifft, strided_dispersion_phase
from .halo import exchange_halos, halo_width

# the JAX module's names; ``LinkMesh`` and ``ShardedField`` are importable by
# name
__all__ = ["make_link_mesh", "ssfm_sharded", "shard_waveform",
           "resolve_shard_method", "AUTO_HALO_FRAC"]

f32 = np.float32

# 'auto' picks overlap-save only when the per-step halo fraction (2H/block)
# is at most this threshold.  The default 0.0 resolves 'auto' to the exact
# pencil transform unless pencil is infeasible; the crossover depends on the
# interconnect (all-to-all against a padded local FFT) and has not been
# measured on several cards: set OPTICOMLIB_TPU_AUTO_HALO_FRAC to a measured
# value to enable overlap below it.
AUTO_HALO_FRAC = float(os.environ.get(
    "OPTICOMLIB_TPU_AUTO_HALO_FRAC", "0.0"))


def resolve_shard_method(n: int, n_time: int, h, beta_2: float,
                         beta_3: float, fs: float,
                         halo_safety: float = 4.0,
                         adaptive: bool = False) -> str:
    """Resolve ``shard_method='auto'`` to 'pencil' or 'overlap' from the
    structural cost ratio ``2H/block`` (halo samples per side over block
    length) against the threshold :data:`AUTO_HALO_FRAC`.

    Adaptive stepping always resolves to 'pencil' where it is feasible: its
    worst-case halo must be sized from a read-back of the input power and
    padded 4x harder because the truncation error feeds back through the
    step controller.  Fixed-step runs pick overlap-save only when the halo
    fraction is within the threshold and the block admits it; pencil
    whenever its exactness is free or overlap is infeasible.
    """
    block = n // n_time
    pencil_ok = block % n_time == 0
    if adaptive or h is None:
        return "pencil" if pencil_ok else "overlap"
    H = halo_width(float(h), beta_2, beta_3, fs, safety=halo_safety)
    if 2 * H >= block:          # overlap infeasible
        return "pencil"
    if not pencil_ok:           # pencil infeasible (n % n_time^2 != 0)
        return "overlap"
    return "overlap" if 2 * H / block <= AUTO_HALO_FRAC else "pencil"


# ---------------------------------------------------------------------------
# the mesh of ranks
# ---------------------------------------------------------------------------
class MeshAxis(NamedTuple):
    """One axis of a :class:`LinkMesh` as this rank sees it."""
    group: object      # the process group of this rank's line along the axis
    size: int
    index: int         # this rank's position along the axis
    ranks: tuple       # global ranks along the axis, in order


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


class LinkMesh:
    """A grid of ranks with named axes (the torch counterpart of
    ``jax.sharding.Mesh(devices, axis_names)``, one rank a device): the
    ('wdm', 'time') grid of :func:`make_link_mesh`, or any other names and
    number of axes (:func:`make_mesh`).  Every axis has its process groups,
    one a line of ranks along it, and the whole mesh has one; this rank
    keeps its own line of each axis (:meth:`axis`).

    The collectives (:meth:`all_reduce`, :meth:`all_gather`,
    :meth:`gather_rows`) run over one named axis, or the whole mesh with
    ``axis=None``; every rank of the line (or mesh) calls them, as it calls
    the point-to-point :meth:`ppermute` along an axis.  Complex tensors
    cross as their float32 (re, im) pairs (NCCL has no complex type)."""

    def __init__(self, ranks, axis_names=("wdm", "time")):
        ranks = np.asarray(ranks, dtype=np.int64)
        names = tuple(axis_names)
        if ranks.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {ranks.shape} needs "
                             f"{ranks.ndim} distinct axis names, got {names}")
        for d in range(ranks.ndim):
            # a process group orders its members by global rank, and the
            # transforms take a rank's place in the group as its index
            if (np.diff(ranks, axis=d) <= 0).any():
                raise ValueError(f"ranks must increase along every axis; "
                                 f"'{names[d]}' of {ranks.tolist()} does not")
        self.ranks = ranks
        self.axis_names = names
        self.shape = dict(zip(names, (int(s) for s in ranks.shape)))
        self.rank = dist.get_rank()
        # a card for NCCL, the CPU for gloo
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        where = np.argwhere(ranks == self.rank)
        if len(where) != 1:
            raise ValueError(
                f"rank {self.rank} is not in the mesh {ranks.tolist()}")
        self.coords = dict(zip(names, (int(i) for i in where[0])))
        world = list(range(dist.get_world_size()))

        def group(members):
            members = [int(r) for r in members]
            return (dist.group.WORLD if members == world
                    else dist.new_group(members))

        # every rank of the world creates every group, in the same order
        self.all_group = group(ranks.reshape(-1))
        self._axes = {}
        for d, name in enumerate(names):
            lines = np.moveaxis(ranks, d, -1).reshape(-1, ranks.shape[d])
            mine = None
            for line in lines:
                g = self.all_group if len(lines) == 1 else group(line)
                if self.rank in line:
                    mine = MeshAxis(g, int(ranks.shape[d]),
                                    self.coords[name],
                                    tuple(int(r) for r in line))
            self._axes[name] = mine
        self._p2p_ready = set()    # the axes that have had a collective

    def axis(self, name: str) -> MeshAxis:
        """The axis ``name`` as this rank sees it: its line's group, size and
        this rank's index along it."""
        if name not in self._axes:
            raise ValueError(
                f"the mesh has no axis '{name}' (axes {self.axis_names})")
        return self._axes[name]

    def size(self, name: Optional[str]) -> int:
        """Ranks along ``name``: 1 for ``None`` or a name the mesh lacks."""
        return self.shape.get(name, 1) if name is not None else 1

    def index(self, name: Optional[str]) -> int:
        """This rank's place along ``name`` (0 where :meth:`size` is 1)."""
        return self.coords.get(name, 0) if name is not None else 0

    # -- collectives --
    def _group(self, axis):
        return self.all_group if axis is None else self.axis(axis).group

    def _members(self, axis) -> int:
        return self.ranks.size if axis is None else self.axis(axis).size

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """``t`` reduced (``"sum"``, ``"max"``, ``"min"`` or ``"mean"``)
        over the ranks of this rank's line along ``axis`` (the whole mesh
        for ``None``): a new tensor, the same on every rank of the line."""
        out = (torch.view_as_real(t) if t.is_complex() else t).clone(
            memory_format=torch.contiguous_format)
        if out.dtype == torch.bool:
            out = out.to(torch.uint8)
        # a view: a 0-d value is reduced as one element
        dist.all_reduce(out.reshape(-1), op=_OPS[op], group=self._group(axis))
        if op == "mean":
            out = out / self._members(axis)
        if t.dtype == torch.bool:
            out = out.to(torch.bool)
        return torch.view_as_complex(out) if t.is_complex() else out

    def all_gather(self, t: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """``t`` of every rank of this rank's line along ``axis`` (the whole
        mesh for ``None``), stacked along a new leading dimension in the
        order of the line (of ``ranks.reshape(-1)``)."""
        mine = torch.view_as_real(t) if t.is_complex() else t
        mine = mine.contiguous()
        parts = [torch.empty_like(mine) for _ in range(self._members(axis))]
        dist.all_gather(parts, mine, group=self._group(axis))
        if axis is None:
            # the group lists its members by global rank
            by_rank = dict(zip(sorted(self.ranks.reshape(-1).tolist()),
                               parts))
            parts = [by_rank[int(r)] for r in self.ranks.reshape(-1)]
        out = torch.stack(parts)
        return torch.view_as_complex(out) if t.is_complex() else out

    def ppermute(self, t: torch.Tensor, axis: str,
                 perm) -> Optional[torch.Tensor]:
        """Point-to-point moves along ``axis``, the counterpart of
        ``jax.lax.ppermute``: ``perm`` holds ``(source, destination)`` pairs
        of positions along the axis (each position at most once a source
        and once a destination), the same list on every rank of the line,
        which all make the call.  A source sends its ``t``; a destination
        returns what it received, a new tensor of ``t``'s shape and dtype,
        and a rank that no pair sends to returns ``None`` (JAX gives zeros).
        Every rank passes a ``t`` of the same shape and dtype, which only
        the sources read: the ring is ``[(i, (i - 1) % S) for i in
        range(S)]``, the open chain ``[(i, i + 1) for i in range(S - 1)]``.
        A pair from a rank to itself is a local copy (NCCL has no send to
        self); complex tensors cross as their float32 (re, im) pairs in one
        ``batch_isend_irecv``.  The first call along an axis of more than
        one rank is preceded by a one-element all-reduce over the axis:
        NCCL requires a group's first collective call to be one that every
        rank of the group joins, and a ``batch_isend_irecv`` joins only the
        ranks of its pairs."""
        ax = self.axis(axis)
        me = ax.index
        for side in zip(*perm):
            if len(set(side)) != len(side):
                raise ValueError(f"a position of '{axis}' appears more than "
                                 f"once as a source or destination in {perm}")
        if ax.size > 1 and axis not in self._p2p_ready:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=ax.group)
            self._p2p_ready.add(axis)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if src and src[0] == me:
            return t.clone(memory_format=torch.contiguous_format)
        ops, recv = [], None
        if dst:
            send = torch.view_as_real(t) if t.is_complex() else t
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  ax.ranks[dst[0]], ax.group))
        if src:
            recv = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            buf = torch.view_as_real(recv) if recv.is_complex() else recv
            ops.append(dist.P2POp(dist.irecv, buf, ax.ranks[src[0]],
                                  ax.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv

    def gather_rows(self, t: torch.Tensor,
                    axis: Optional[str]) -> torch.Tensor:
        """This rank's block of rows ``(r, ...)`` and those of the others
        along ``axis``, concatenated ``(size * r, ...)`` in axis order: the
        rows of every 'wdm' row of the mesh on every rank (``axis=None``
        leaves ``t`` as it is: its rows are already all of them)."""
        if axis is None:
            return t
        return self.all_gather(t, axis).reshape((-1,) + tuple(t.shape[1:]))

    def __repr__(self):
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"LinkMesh({shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")


_meshes: dict = {}


def make_mesh(ranks, axis_names) -> LinkMesh:
    """A mesh of the global ``ranks`` (an array whose shape is the mesh's)
    with one name an axis: the counterpart of
    ``jax.sharding.Mesh(devices, axis_names)``, e.g.
    ``make_mesh(range(4), ("wdm",))`` or ``make_mesh(np.arange(4).reshape(2,
    2), ("ch", "t"))``.  Every rank of the world makes the same call (the
    mesh creates process groups); a mesh is built once per (ranks, names)
    and kept."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs torch.distributed: call initialize_multihost() "
            "first (one rank is enough)")
    ranks = np.asarray(list(ranks) if not isinstance(ranks, np.ndarray)
                       else ranks, dtype=np.int64)
    key = (ranks.shape, tuple(ranks.reshape(-1).tolist()), tuple(axis_names))
    if key not in _meshes:
        _meshes[key] = LinkMesh(ranks, axis_names)
    return _meshes[key]


def make_link_mesh(n_wdm: int = 1, n_time: Optional[int] = None,
                   devices=None) -> LinkMesh:
    """Build a ('wdm', 'time') mesh of ranks.

    ``devices``: the global ranks to use, in order (default: every rank of
    the world); ``n_time`` defaults to ``len(devices) // n_wdm`` so all of
    them are used.  ``torch.distributed`` must be initialised
    (:func:`~opticomlib_tpu_torch.parallel.multihost.initialize_multihost`)
    and every rank of the world must make the same call: the mesh creates
    process groups.  A mesh is built once per (shape, ranks) and kept.
    Other names and shapes: :func:`make_mesh`.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_link_mesh needs torch.distributed: call "
            "initialize_multihost() first (one rank is enough)")
    devices = (list(range(dist.get_world_size())) if devices is None
               else [int(r) for r in devices])
    if n_time is None:
        n_time = len(devices) // n_wdm
    n = n_wdm * n_time
    if n > len(devices):
        raise ValueError(
            f"mesh {n_wdm}x{n_time} needs {n} devices, have {len(devices)}")
    return make_mesh(np.asarray(devices[:n]).reshape(n_wdm, n_time),
                     ("wdm", "time"))


# ---------------------------------------------------------------------------
# the sharded field
# ---------------------------------------------------------------------------
def _whole_of(x):
    return x.whole() if isinstance(x, ShardedField) else x


def _unshard(obj):
    """``obj`` with every :class:`ShardedField` in it (also inside lists,
    tuples and dicts) replaced by its whole tensor."""
    if isinstance(obj, ShardedField):
        return obj.whole()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unshard(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _unshard(v) for k, v in obj.items()}
    return obj


def _delegate(name):
    def op(self, *args):
        return getattr(self.whole(), name)(*map(_whole_of, args))
    op.__name__ = name
    return op


class ShardedField:
    """A waveform spread over a :class:`LinkMesh`: this rank's block
    (``local``, on the rank's device: the complex64 field, or a real
    waveform of the sharded link), the global ``shape`` and the mesh.
    Samples (the last axis) are split over ``time_axis`` ('time'); the rows
    (the first axis) of a field of several over ``wdm_axis`` ('wdm'), or
    held whole by every rank (``None``).

    The next sharded call (``ssfm_sharded``, ``FIBER(mesh=...)``) takes it
    as it is, each block where it lies.  Anything else sees the whole
    field, as the JAX package's global array is seen: tensor operators,
    ``torch`` functions, indexing and tensor methods act on
    :meth:`whole`, the field gathered onto this rank's device (a collective
    that every rank of the mesh calls, made once and kept), and
    ``np.asarray(field)`` / :meth:`gather` give it as a host array.
    ``shape``, ``ndim``, ``dtype``, ``device`` and ``numel()`` are the
    whole field's and need no gather.  ``n_steps`` is the step count of the
    propagation that produced it, where one did.
    """

    def __init__(self, local: torch.Tensor, mesh: LinkMesh, shape,
                 wdm_axis: Optional[str], time_axis: str = "time"):
        self.local = local
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.wdm_axis = wdm_axis if len(self.shape) >= 2 else None
        self.time_axis = time_axis
        self.n_steps: Optional[int] = None
        self._whole = None
        if tuple(local.shape) != self.block_shape(
                mesh, self.shape, self.wdm_axis, time_axis):
            raise ValueError(
                f"block {tuple(local.shape)} does not fit a field "
                f"{self.shape} on {mesh!r}")

    # -- layout --
    @staticmethod
    def block_shape(mesh, shape, wdm_axis, time_axis="time"):
        lead = list(shape[:-1])
        if lead and wdm_axis:
            lead[0] //= mesh.size(wdm_axis)
        return tuple(lead) + (shape[-1] // mesh.size(time_axis),)

    @staticmethod
    def block_indices(mesh, shape, wdm_axis, coords=None, time_axis="time"):
        """Global ``[[start, stop], ...]`` bounds, one pair a dimension, of
        the block of the rank at ``coords`` (default: this rank)."""
        coords = mesh.coords if coords is None else coords
        B = shape[-1] // mesh.size(time_axis)
        j = coords.get(time_axis, 0)
        out = [[0, int(d)] for d in shape[:-1]] + [[j * B, (j + 1) * B]]
        if len(shape) > 1 and wdm_axis:
            R = shape[0] // mesh.size(wdm_axis)
            i = coords.get(wdm_axis, 0)
            out[0] = [i * R, (i + 1) * R]
        return out

    @property
    def indices(self):
        return self.block_indices(self.mesh, self.shape, self.wdm_axis,
                                  time_axis=self.time_axis)

    #: what the signal classes look for in a payload (they do not import
    #: this module)
    is_sharded = True

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def numel(self) -> int:
        return int(np.prod(self.shape))

    # -- the whole field --
    def whole(self) -> torch.Tensor:
        """The whole field as a tensor on this rank's device: an all-gather
        of the blocks over the mesh, made on the first call and kept.  Every
        rank of the mesh calls it."""
        if self._whole is None:
            mesh = self.mesh
            blocks = mesh.all_gather(self.local)
            out = torch.empty(self.shape, dtype=self.local.dtype,
                              device=self.local.device)
            for k, idx in enumerate(np.ndindex(*mesh.ranks.shape)):
                bounds = self.block_indices(
                    mesh, self.shape, self.wdm_axis,
                    dict(zip(mesh.axis_names, idx)), self.time_axis)
                out[tuple(slice(a, b) for a, b in bounds)] = blocks[k]
            self._whole = out
        return self._whole

    def gather(self) -> np.ndarray:
        """The whole field as a host array (see :meth:`whole`)."""
        return self.whole().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.gather()
        return out if dtype is None else out.astype(dtype)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unshard(args), **_unshard(kwargs or {}))

    __add__, __radd__ = _delegate("__add__"), _delegate("__radd__")
    __sub__, __rsub__ = _delegate("__sub__"), _delegate("__rsub__")
    __mul__, __rmul__ = _delegate("__mul__"), _delegate("__rmul__")
    __truediv__ = _delegate("__truediv__")
    __rtruediv__ = _delegate("__rtruediv__")
    __pow__, __rpow__ = _delegate("__pow__"), _delegate("__rpow__")
    __neg__, __abs__ = _delegate("__neg__"), _delegate("__abs__")
    __getitem__, __iter__ = _delegate("__getitem__"), _delegate("__iter__")
    __matmul__ = _delegate("__matmul__")
    __eq__, __ne__ = _delegate("__eq__"), _delegate("__ne__")
    __lt__, __le__ = _delegate("__lt__"), _delegate("__le__")
    __gt__, __ge__ = _delegate("__gt__"), _delegate("__ge__")
    __hash__ = object.__hash__

    def __len__(self):
        return self.shape[0]

    def __getattr__(self, name):
        # only reached for a name the class does not have: a tensor
        # attribute or method, which the whole field answers
        if name.startswith("__") or name in ("local", "mesh", "_whole"):
            raise AttributeError(name)
        return getattr(self.whole(), name)

    def __repr__(self):
        return (f"ShardedField(shape={self.shape}, block "
                f"{tuple(self.local.shape)} at {self.indices}, "
                f"{self.mesh!r})")


def shard_waveform(A, mesh: LinkMesh, wdm_axis: Optional[str] = "wdm",
                   time_axis: str = "time") -> ShardedField:
    """Place a (channels, nsamples) or (nsamples,) field on the mesh with
    channels over ``wdm_axis`` (None, or a name the mesh lacks -> every
    rank holds all channels) and samples over ``time_axis``.  ``A``: the
    whole field on every rank (host data or a tensor; each rank keeps its
    block, on its device), or a :class:`ShardedField` of this mesh and
    layout, returned as it is.

    A tensor must lie where the mesh computes (``mesh.device``: the rank's
    card under NCCL, the CPU under gloo): a tensor on the card handed to a
    CPU mesh raises, it is not copied to the host."""
    mesh.axis(time_axis)
    if wdm_axis is not None and wdm_axis not in mesh.axis_names:
        wdm_axis = None
    if isinstance(A, ShardedField):
        want = wdm_axis if A.ndim == 2 else None
        if (A.mesh is not mesh or A.wdm_axis != want
                or A.time_axis != time_axis):
            raise ValueError(
                f"{A!r} is laid out for another mesh or axes (asked: "
                f"{mesh!r}, wdm_axis={wdm_axis!r}, time_axis="
                f"{time_axis!r}); gather it first")
        return A
    if not isinstance(A, torch.Tensor):
        A = torch.from_numpy(np.asarray(A))
    elif A.device.type != mesh.device.type:
        raise ValueError(
            f"the field lies on {A.device} but the mesh computes on "
            f"{mesh.device} (process group backend "
            f"'{dist.get_backend()}'): only host data is placed on a mesh.  "
            "Start the ranks on the field's device, "
            "initialize_multihost(device=...), or pass a host array")
    shape = tuple(A.shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"field must be 1-D or 2-D, got shape {shape}")
    n_time = mesh.size(time_axis)
    if shape[-1] % n_time:
        raise ValueError(f"nsamples {shape[-1]} not divisible by time "
                         f"shards {n_time}")
    wdm_axis = wdm_axis if len(shape) == 2 else None
    if wdm_axis and shape[0] % mesh.size(wdm_axis):
        raise ValueError(f"{shape[0]} channels not divisible by wdm shards "
                         f"{mesh.size(wdm_axis)}")
    idx = ShardedField.block_indices(mesh, shape, wdm_axis,
                                     time_axis=time_axis)
    local = A[tuple(slice(a, b) for a, b in idx)].to(
        device=mesh.device, dtype=torch.complex64).contiguous()
    return ShardedField(local, mesh, shape, wdm_axis, time_axis)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------
#: what is costly to rebuild per call (the rank's phase grid), keyed as the
#: JAX package keys its compiled programs, least recently used first
_plan_cache: "OrderedDict" = OrderedDict()
_PLAN_CACHE_MAX = 32  # adaptive-overlap keys include the power-derived halo
# step, so unbounded sweeps would leak phase grids


def _plan_cache_put(key, plan):
    _plan_cache[key] = plan
    _plan_cache.move_to_end(key)
    while len(_plan_cache) > _PLAN_CACHE_MAX:
        _plan_cache.popitem(last=False)


def ssfm_sharded(
    A,
    mesh: LinkMesh,
    fs: float,
    length: float,
    alpha: float = 0.0,
    beta_2: float = 0.0,
    beta_3: float = 0.0,
    gamma: float = 0.0,
    h: Optional[float] = 1.0,
    phi_max: float = 0.01,
    method: str = "pencil",
    halo_safety: float = 4.0,
    time_axis: str = "time",
    wdm_axis: Optional[str] = "wdm",
    ckpt_dir: Optional[str] = None,
    segment_km: Optional[float] = None,
    scheme: str = "reference",
    tol: float = 1e-5,
) -> ShardedField:
    """Propagate a sharded waveform through ``length`` km of fiber.  Every
    rank of the mesh makes the same call.

    ``scheme`` selects the splitting scheme (mirrors
    ``devices.FIBER(method=)``): ``"reference"`` (default: the 2nd-order
    frozen-operator step, phi_max-adaptive or fixed ``h``), ``"o4"``
    (4th-order Yoshida: fixed schedule with ``h``, self-tuning
    step-doubling control at ``tol`` with ``h=None``), or
    ``"local_error"`` (Sinkin adaptive stepping at ``tol``).  The
    higher-order schemes run on the pencil-FFT path with their error
    norms all-reduced over the mesh, so every rank agrees on the step
    sequence; they are not available with ``method='overlap'`` (the
    halo width is derived for the reference step).  Checkpointing
    composes with every scheme (the scheme is part of the config
    fingerprint; the self-tuning controllers restart per segment).

    ``A``: (nsamples,) or (channels, nsamples) complex field: the whole
    field on every rank (host data or a tensor; each rank slices its
    block), or a :class:`ShardedField` of this mesh.  Returns a
    :class:`ShardedField` of the same shape, with ``n_steps``.

    ``h``: fixed step [km], or ``None`` for **phi_max-adaptive stepping**
    (the reference criterion, devices.py:1156/1193-1196): the per-step
    ``max|A|^2`` is all-reduced (max) over the mesh, so all ranks advance
    with one global step size, matching the single-device adaptive result.

    ``method``:
      * ``"pencil"`` (default): exact distributed FFT per linear step
        (2 all-to-all per transform; matches the single-device result to
        float32 round-off);
      * ``"overlap"``: blockwise overlap-save with ring halo exchange
        (neighbour sends only; cheaper on the interconnect but
        approximate: the truncation error decays ~1/H^2 in the halo
        width);
      * ``"auto"``: :func:`resolve_shard_method`.

    ``ckpt_dir``: checkpoint/resume.  The span is run in segments of
    ``segment_km`` (default: the whole span), the field saved after each
    segment (:class:`opticomlib_tpu_torch.runtime.PropagationCheckpointer`;
    with several ranks each writes its block as ``shard=rank``); a rerun
    with the same directory and physics resumes from the latest checkpoint
    every rank holds and reproduces the uninterrupted segmented run bit for
    bit (adaptive stepping re-probes h0 at each segment boundary in both
    cases).

    The rank's phase grid is kept per (mesh, shape, physics, method):
    repeated calls with the same configuration rebuild nothing.
    """
    if scheme not in ("reference", "o4", "local_error"):
        raise ValueError(
            "scheme must be 'reference', 'o4' or 'local_error'")
    if scheme != "reference":
        if method == "overlap":
            raise ValueError(
                f"scheme='{scheme}' needs the exact pencil-FFT path "
                "(method='pencil' or 'auto'); the overlap halo width is "
                "derived for the reference step")
        method = "pencil"
    if ckpt_dir is not None:
        return _ssfm_sharded_resumable(
            A, mesh, fs, length, alpha, beta_2, beta_3, gamma, h,
            phi_max, method, halo_safety, time_axis, wdm_axis,
            ckpt_dir, segment_km, scheme=scheme, tol=tol)
    shape = tuple(A.shape) if hasattr(A, "shape") else np.shape(A)
    n = shape[-1]
    axis = mesh.axis(time_axis)
    n_time = axis.size
    if n % n_time:
        raise ValueError(f"nsamples {n} not divisible by time shards {n_time}")
    block = n // n_time
    x = shard_waveform(A, mesh, wdm_axis if len(shape) == 2 else None,
                       time_axis)
    wdm_axis = x.wdm_axis

    adaptive = h is None
    if adaptive and gamma == 0:
        # linear-only: single step over the whole span (reference h0=length)
        h, adaptive = length, False
    if method == "auto":
        method = resolve_shard_method(
            n, n_time, None if adaptive else min(float(h), float(length)),
            beta_2, beta_3, fs, halo_safety=halo_safety,
            adaptive=adaptive)

    # collectives: the adaptive max reduction must see every block of the
    # waveform: the time blocks and (parity with the single-device solver,
    # which maxes over the whole array) the channels
    over = time_axis if wdm_axis is None else None

    def reduce_max(m):
        return mesh.all_reduce(m, "max", over)

    def reduce_sum(s):
        return mesh.all_reduce(s, "sum", over)

    if adaptive and method == "overlap":
        # worst-case adaptive step (sizes the overlap halo):
        # maxP(z) >= maxP0 * e^(-alpha*L), so h(z) <= h0 * e^(+alpha*L)
        maxP0 = float(max_power(x.local, reduce_max))
        h0_host = adaptive_h0(phi_max, gamma, maxP0, length)
        h_for_halo = min(length,
                         h0_host * math.exp(alpha_per_km(alpha) * length))
    else:
        h_for_halo = None if adaptive else h
    hs = ssfm_step_schedule(length, h if not adaptive else length)

    cache_key = (mesh.axis_names, tuple(mesh.ranks.reshape(-1).tolist()),
                 shape, method, float(fs), float(length), float(alpha),
                 float(beta_2), float(beta_3), float(gamma), h, adaptive,
                 float(phi_max), float(halo_safety), time_axis, wdm_axis,
                 scheme, float(tol),
                 (round(float(h_for_halo), 9)
                  if method == "overlap" else None))
    plan = _plan_cache.get(cache_key)
    if plan is not None:
        _plan_cache.move_to_end(cache_key)
    elif method == "pencil":
        if block % n_time:
            raise ValueError(
                f"pencil FFT needs block ({block}) divisible by time shards "
                f"({n_time}) — i.e. nsamples divisible by n_time^2")
        # the linear operator on the strided spectrum layout this rank owns
        # after pencil_fft, in float32 as the JAX solver evaluates it
        plan = dict(phi=strided_dispersion_phase(
            axis.index, n_time, block, fs, beta_2, beta_3, mesh.device))
        _plan_cache_put(cache_key, plan)
    elif method == "overlap":
        # adaptive mode: truncation error feeds back through the step
        # controller (h depends on max|A|^2, which halo error perturbs),
        # so pad the halo harder than the fixed-step case
        eff_safety = halo_safety * (4.0 if adaptive else 1.0)
        H = halo_width(float(min(h_for_halo, length)), beta_2, beta_3, fs,
                       safety=eff_safety)
        if 2 * H >= block:
            raise ValueError(
                f"halo {H} too large for block {block}; increase samples per "
                f"device or reduce step size")
        # dispersion phase on the padded-block grid
        w_pad = 2 * np.pi * np.fft.fftfreq(block + 2 * H) * fs
        plan = dict(H=H, phi=torch.as_tensor(
            dispersion_phase(w_pad, beta_2, beta_3), device=mesh.device))
        _plan_cache_put(cache_key, plan)
    else:
        raise ValueError("method must be 'pencil' or 'overlap'")
    phi = plan["phi"]

    if method == "pencil":
        def spectral(a, E):
            return pencil_ifft(kernels.cmul(pencil_fft(a, axis), E), axis)
    else:
        H = plan["H"]

        def spectral(a, E):
            # overlap-save with ring halos (circular semantics)
            ap = exchange_halos(a, H, axis)
            ap = torch.fft.ifft(kernels.cmul(torch.fft.fft(ap, dim=-1), E),
                                dim=-1)
            # a copy, not a view: a view would start 8*H bytes into the
            # padded buffer (off cmul's 16-byte vector path when H is odd)
            # and keep the whole buffer alive
            return ap[..., H:-H].clone(memory_format=torch.contiguous_format)

    a_km, g32 = f32(alpha_per_km(alpha)), f32(gamma)
    with torch.no_grad():
        if scheme != "reference":
            if scheme == "o4" and h is not None:
                y, steps = ssfm_o4_scan_inside(
                    x.local, phi, hs, g32, a_km, spectral=spectral), len(hs)
            else:
                fn = (ssfm_o4_auto_inside if scheme == "o4"
                      else ssfm_local_error_inside)
                # a user-supplied h acts as the initial step h0, same as
                # the unsharded ssfm_local_error
                h0 = (min(float(h), float(length)) if h is not None
                      else float(length) / 10.0)
                y, steps = fn(x.local, phi, length, g32, tol, h0, a_km,
                              reduce_sum=reduce_sum, spectral=spectral)
        elif adaptive:
            h0 = _first_step(phi_max, g32, max_power(x.local, reduce_max),
                             length)
            y, steps = ssfm_while_inside(
                x.local, None, length, g32, phi_max, h0, a_km,
                adaptive=True, reduce_max=reduce_max,
                linear_step=lambda a, hh: spectral(
                    a, _lin_factor(phi, a_km, hh)),
                h_max=h_for_halo if method == "overlap" else None)
        else:
            y, steps = ssfm_scan_inside(x.local, phi, hs, g32, a_km,
                                        spectral=spectral), len(hs)
    out = ShardedField(y, mesh, shape, wdm_axis, time_axis)
    out.n_steps = int(steps)
    return out


def _ssfm_sharded_resumable(A, mesh, fs, length, alpha, beta_2, beta_3,
                            gamma, h, phi_max, method, halo_safety,
                            time_axis, wdm_axis, ckpt_dir, segment_km,
                            scheme="reference", tol=1e-5):
    """Segmented sharded propagation with checkpoint/resume.  The field is
    saved after every segment; a rerun with the same directory and physics
    resumes from the latest valid checkpoint, and the resumed output is
    bit-identical to the uninterrupted segmented run (both re-probe the
    adaptive h0 at each segment boundary from the same field).

    On one rank the whole field is one file.  With several, each rank
    writes only its block (``shard=rank`` files, with the block's global
    bounds under ``extra["indices"]``) and resumes from it: the field is
    never gathered to one rank."""
    from ..runtime.checkpoint import PropagationCheckpointer

    seg = float(segment_km) if segment_km else float(length)
    nproc = dist.get_world_size()
    shape = tuple(A.shape) if hasattr(A, "shape") else np.shape(A)
    cfg = dict(kind="ssfm_sharded", n=list(shape), fs=fs, length=length,
               alpha=alpha, beta_2=beta_2, beta_3=beta_3, gamma=gamma,
               h=h, phi_max=phi_max, method=method, segment_km=seg,
               halo_safety=halo_safety, time_axis=time_axis,
               wdm_axis=wdm_axis, scheme=scheme, tol=tol,
               mesh=[list(mesh.axis_names),
                     [int(r) for r in mesh.ranks.reshape(-1)]])
    ck = PropagationCheckpointer(
        ckpt_dir, config=cfg, shard=mesh.rank if nproc > 1 else None)
    layout = (wdm_axis if len(shape) == 2 and wdm_axis in mesh.axis_names
              else None)

    state = ck.latest() if nproc == 1 else _multihost_agreed_state(ck, mesh)
    if state is not None:
        step, z, re, im, extra = state
        block = (re + 1j * im).astype(np.complex64)
        if nproc > 1:
            if extra["indices"] != [ShardedField.block_indices(
                    mesh, shape, layout, time_axis=time_axis)]:
                raise ValueError(
                    f"checkpoint block {extra['indices']} is not this "
                    f"rank's block of the field")
            A = ShardedField(torch.as_tensor(block[0], device=mesh.device),
                             mesh, shape, layout, time_axis)
        else:
            A = shard_waveform(block, mesh, layout, time_axis)
    else:
        step, z = 0, 0.0
        A = shard_waveform(A, mesh, layout, time_axis)
    while z < length - 1e-9:
        this = min(seg, length - z)
        A = ssfm_sharded(A, mesh, fs, this, alpha=alpha, beta_2=beta_2,
                         beta_3=beta_3, gamma=gamma, h=h, phi_max=phi_max,
                         method=method, halo_safety=halo_safety,
                         time_axis=time_axis, wdm_axis=wdm_axis,
                         scheme=scheme, tol=tol)
        z += this
        step += 1
        local = A.local.cpu().numpy()
        if nproc == 1:
            ck.save(step, z, local.real, local.imag)
        else:
            ck.save(step, z, local.real[None], local.imag[None],
                    extra={"indices": [A.indices]})
    return A


def _multihost_agreed_state(ck, mesh):
    """Resume state all ranks AGREE on (world size > 1).

    Each rank independently keeps its own shard checkpoints; a crash
    between the ranks' saves, or one rank falling back past a corrupt
    file, leaves ranks with different latest steps, and the following
    segments would combine blocks propagated to different distances.  So
    before resuming, every rank gathers the set of steps it can actually
    load (corrupt files excluded by a real load attempt) and all resume
    from the **highest step available on every rank**, or from scratch
    when no common step exists.
    """
    keep = ck.keep
    mine = [s for s in ck._steps() if ck.load(s) is not None][-keep:]
    vec = torch.full((keep,), -1, dtype=torch.int64, device=mesh.device)
    vec[:len(mine)] = torch.as_tensor(mine, dtype=torch.int64)
    rows = [torch.empty_like(vec) for _ in range(mesh.ranks.size)]
    dist.all_gather(rows, vec, group=mesh.all_group)
    sets = [set(int(s) for s in row.tolist() if s >= 0) for row in rows]
    common = set.intersection(*sets) if sets else set()
    if not common:
        return None
    return ck.load(max(common))
