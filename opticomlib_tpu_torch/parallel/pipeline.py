"""Span-pipeline parallelism: each rank owns a run of fiber spans (port of
``opticomlib_tpu.parallel.pipeline`` to ``torch.distributed``).

The pipeline-parallel axis of optical links (the per-span FIBER+EDFA chain
of reference examples/ook_transmission_fiber_simulation.py).  Rank ``d`` of
the ``('span',)`` mesh holds segments ``[d*K, (d+1)*K)`` of an ``S*K``
segment chain; a batch of ``B`` waveforms (WDM channels, Monte-Carlo shots,
parameter sweeps) streams through as microbatches, one a tick:

  tick t:  rank 0 takes microbatch ``t`` from its owner; rank ``d`` runs its
           K segments on microbatch ``m = t - d`` and passes it to ``d + 1``;
           the last rank sends finished microbatch ``t - S + 1`` home.

After ``B + S - 1`` ticks every microbatch has traversed every segment.

**Memory is O(B/S * n) a rank.**  The batch is sharded over the 'span'
axis, rank ``d`` owning microbatches ``[d*C, (d+1)*C)`` with ``C = B/S``, in
and out, and no rank holds the whole batch.  The schedule is plainer than
the JAX package's two rotating ring buffers (one ``ppermute`` of a
microbatch a rank and a tick): each tick makes at most three point-to-point
moves of one microbatch (:meth:`~opticomlib_tpu_torch.parallel.fiber.
LinkMesh.ppermute`): owner to rank 0, the chain ``d -> d + 1`` between the
ranks that ran a microbatch that tick, and the last rank to the owner.
Every rank walks the same schedule, so every rank posts the same moves in
the same order, and a rank computes nothing on a tick without a microbatch
(JAX computes on zeros there).  At one rank every move is a local copy.

Each active microbatch lives wholly on one rank at a time, so a segment is
the single-device split-step solver: kicks through ``kernels.nl_halfstep``,
spectral multiplies through ``kernels.cmul``, as in :mod:`..ops.ssfm`.

Noise is keyed by position, not by schedule: the ASE of microbatch ``m`` in
segment ``s`` comes from a generator seeded with ``(seed, m, s)`` (NumPy's
``SeedSequence``), so a pipelined run is bit-identical to the sequential
segment chain (one rank) on the same seed.  ``noise=`` takes injected unit
draws instead, e.g. the JAX package's ``fold_in`` draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import filters, kernels
from ..ops.noise import as_draw, ase_sigma, gaussian, keyed_generator
from ..ops.ssfm import (_MAX_STEPS, _W0, _W1, _first_step, _lin_factor,
                        _nl_l_nl_step, _o4_step, alpha_per_km,
                        dispersion_phase, max_power, ssfm_local_error_inside,
                        ssfm_o4_auto_inside, ssfm_scan_inside,
                        ssfm_step_schedule, ssfm_while_inside)
from .fiber import ShardedField, make_mesh

__all__ = ["make_span_mesh", "span_pipeline", "span_pipeline_stages",
           "pipeline_stages_core"]

f32 = np.float32


def make_span_mesh(n_spans: int, devices=None):
    """1-D ``('span',)`` mesh of ``n_spans`` ranks, one a pipeline stage:
    the first ``n_spans`` of the global ranks ``devices`` (default: every
    rank of the world).  Every rank of the world makes the same call (the
    mesh creates process groups)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_span_mesh needs torch.distributed: call "
            "initialize_multihost() first (one rank is enough)")
    devices = (list(range(dist.get_world_size())) if devices is None
               else [int(r) for r in devices])
    if n_spans > len(devices):
        raise ValueError(f"{n_spans} spans need {n_spans} devices, "
                         f"have {len(devices)}")
    return make_mesh(devices[:n_spans], ("span",))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------
def _run_schedule(step, feed: torch.Tensor, mesh, span_axis: str, B: int):
    """Stream the ``B`` microbatches through the ranks of ``span_axis``.
    ``feed``: this rank's ``(C, ...)`` microbatches; ``step(x, m)``: this
    rank's stage on microbatch ``m``.  Returns this rank's ``(C, ...)``
    finished microbatches."""
    ax = mesh.axis(span_axis)
    S, d = ax.size, ax.index
    C = B // S
    out = torch.empty_like(feed)
    blank = feed[0]            # the shape a rank that sends nothing passes
    pipe = None
    for t in range(B + S - 1):
        x = None
        if t < B:
            owner, slot = divmod(t, C)
            x = mesh.ppermute(feed[slot], span_axis, [(owner, 0)])
        if d > 0:
            x = pipe
        m = t - d
        y = step(x, m) if 0 <= m < B else None
        chain = [(i, i + 1) for i in range(S - 1) if 0 <= t - i < B]
        pipe = mesh.ppermute(blank if y is None else y, span_axis, chain)
        done = t - (S - 1)
        if 0 <= done < B:
            owner, slot = divmod(done, C)
            r = mesh.ppermute(blank if y is None else y, span_axis,
                              [(S - 1, owner)])
            if d == owner:
                out[slot] = r
    return out


def _local_rows(A_batch, mesh, span_axis: str) -> torch.Tensor:
    """This rank's rows of the batch as complex64 on the mesh's device:
    the whole batch (host data or a tensor on the mesh's device type),
    every rank passing it, or a ``ShardedField`` already over the axis."""
    dev = mesh.device
    if isinstance(A_batch, ShardedField):
        if A_batch.mesh is mesh and A_batch.wdm_axis == span_axis:
            return A_batch.local.to(torch.complex64)
        A_batch = A_batch.whole()
    if isinstance(A_batch, torch.Tensor):
        if A_batch.device.type != dev.type:
            raise ValueError(
                f"the batch lies on {A_batch.device}, the mesh computes on "
                f"{dev}: pass host data or a tensor there")
    else:
        A_batch = torch.from_numpy(np.asarray(A_batch, dtype=np.complex64))
    if A_batch.ndim != 2:
        raise ValueError("A_batch must be (B, n)")
    ax = mesh.axis(span_axis)
    B = A_batch.shape[0]
    if B % ax.size:
        raise ValueError(
            f"batch size {B} must be a multiple of the span count "
            f"{ax.size} (each device owns B/S microbatches)")
    C = B // ax.size
    rows = A_batch[ax.index * C:(ax.index + 1) * C]
    return rows.to(device=dev, dtype=torch.complex64).contiguous()


# ---------------------------------------------------------------------------
# identical spans
# ---------------------------------------------------------------------------
@torch.no_grad()
def span_pipeline(A_batch, mesh, fs: float, span_length: float,
                  alpha: float = 0.0, beta_2: float = 0.0,
                  beta_3: float = 0.0, gamma: float = 0.0,
                  h: Optional[float] = 1.0, phi_max: float = 0.05,
                  gain_db: Optional[float] = None, NF: Optional[float] = None,
                  f0: Optional[float] = None, seed: int = 0,
                  span_axis: str = "span", noise=None) -> ShardedField:
    """Propagate ``B`` waveforms through ``S`` identical spans (SSFM + EDFA
    gain, optionally with keyed ASE), one a rank of ``span_axis``,
    pipelined.

    ``A_batch``: ``(B, n)`` complex, ``B`` a multiple of ``S`` (every rank
    passes the whole batch and keeps its rows, or a ``ShardedField`` over
    the axis).  ``h``: fixed SSFM step [km]; ``None``: phi_max-adaptive
    stepping, the step sizes chosen from the microbatch on its rank.
    ``gain_db``: the span amplifier's gain [dB] (default ``alpha *
    span_length``, a transparent link).  ``NF``: with it, each span's gain
    is followed by ASE of power ``idb(NF)*h*f0*(G-1)*fs`` on the carried
    polarization, drawn for (microbatch ``m``, span ``d``) from a generator
    keyed by ``(seed, m, d)``; ``noise[m][d]``: ``(2, n)`` unit draws to
    use instead.  ``f0``: carrier frequency [Hz] (default c/1550 nm).

    Returns a ``(B, n)`` complex64 ``ShardedField`` over ``span_axis``
    (rank ``d`` holds rows ``[d*B/S, (d+1)*B/S)``): every microbatch after
    all ``S`` spans, what the spans applied one after another give."""
    feed = _local_rows(A_batch, mesh, span_axis)
    S = mesh.axis(span_axis).size
    B, n = feed.shape[0] * S, feed.shape[1]
    dev = mesh.device
    if gain_db is None:
        gain_db = alpha * span_length
    g_field = float(f32(10.0 ** (gain_db / 20.0)))
    sigma_ase = 0.0
    if NF is not None:
        from scipy.constants import c as c_light
        sigma_ase = ase_sigma(gain_db, NF,
                              c_light / 1550e-9 if f0 is None else f0, fs)
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    phi_w = torch.as_tensor(dispersion_phase(w, beta_2, beta_3), device=dev)
    a_km = alpha_per_km(alpha)
    adaptive = h is None and gamma != 0 and (beta_2 != 0 or beta_3 != 0)
    if h is None and not adaptive:
        h = span_length  # linear-only: one step (reference h0 = length)
    hs = None if adaptive else ssfm_step_schedule(span_length, h)
    d = mesh.axis(span_axis).index

    def span(x, m):
        if adaptive:
            h0 = _first_step(phi_max, gamma, max_power(x), span_length)
            x, _ = ssfm_while_inside(x, phi_w, span_length, gamma, phi_max,
                                     h0, a_km, adaptive=True)
        else:
            x = ssfm_scan_inside(x, phi_w, hs, gamma, a_km)
        x = x * g_field
        if sigma_ase:
            dr = gaussian((2, n), sigma_ase,
                          None if noise is not None
                          else keyed_generator(dev, seed, m, d),
                          None if noise is None
                          else as_draw(noise[m][d], dev))
            x = x + torch.complex(dr[0], dr[1])
        return x

    out = _run_schedule(span, feed, mesh, span_axis, B)
    return ShardedField(out, mesh, (B, n), span_axis, None)


# ---------------------------------------------------------------------------
# heterogeneous stage blocks: the LinkSpec stage vocabulary over the ranks
# ---------------------------------------------------------------------------
def _flatten_stage_specs(stages):
    """Expand RepeatSpec blocks into a flat stage list."""
    from ..link import RepeatSpec

    flat = []
    for st in stages:
        if isinstance(st, RepeatSpec):
            for _ in range(st.n):
                flat.extend(st.stages)
        else:
            flat.append(st)
    return flat


def _stage_segments(stages, fs, f0, n):
    """Lower a flat LinkSpec stage tuple to per-segment parameter vectors
    (copied from ``opticomlib_tpu.parallel.pipeline``).

    A *segment* is one pipeline work unit: ``x *= pre; SSFM(length,
    scheme); x *= gain; x += keyed 2-pol ASE; x = |H|^2 filter`` — every
    piece optional.  ``FiberSpec`` (+ an immediately following ``EDFASpec``
    merged in; ``DBPSpec`` folds its sign flip and undo-gain into (beta,
    gamma, alpha, pre)), a standalone ``EDFASpec`` (zero length: gain, ASE,
    its ``BW`` band-pass), ``DMSpec`` (a linear-only unit segment with
    ``beta_2 * length = D``) and ``BPFSpec`` (zero length, its |H|^2 only).

    Returns (params dict of float64 np arrays, any_ase flag, h2_bank (R, n)
    float32 array of zero-phase responses — ``params['h2_idx'] >= 0``
    indexes into it)."""
    from scipy.constants import c as c_light

    from ..link import BPFSpec, DBPSpec, DMSpec, EDFASpec, FiberSpec

    if f0 is None:
        f0 = c_light / 1550e-9

    flat = _flatten_stage_specs(stages)
    cols = {k: [] for k in ("pre", "length", "h", "phi_max", "alpha",
                            "beta_2", "beta_3", "gamma", "gain",
                            "sigma_ase", "scheme", "tol", "h2_idx")}
    h2_bank = []
    h2_cache = {}

    def _h2(order: int, BW_lp: float) -> int:
        """Register a |H|^2 response in the bank, deduplicated."""
        key = (int(order), float(BW_lp))
        if key not in h2_cache:
            h2_cache[key] = len(h2_bank)
            h2_bank.append(np.asarray(filters.bessel_filtfilt_response(
                int(order), float(BW_lp), float(fs), int(n)),
                dtype=np.float32))
        return h2_cache[key]

    def push(pre=1.0, length=0.0, h=0.0, phi_max=0.05, alpha=0.0,
             beta_2=0.0, beta_3=0.0, gamma=0.0, gain=1.0, sigma_ase=0.0,
             scheme=0.0, tol=1e-5, h2_idx=-1.0):
        for k, v in locals().items():
            if k in cols:
                cols[k].append(float(v))

    def edfa_vals(st):
        if st.NF is not None and st.G < 0:
            # the fused link's build-time check (link._stage_plan): a
            # negative-gain ASE draw would NaN sigma
            raise ValueError("EDFASpec with ASE (NF set) needs G >= 0 dB")
        gain = 10.0 ** (st.G / 20.0)
        sig = ase_sigma(st.G, st.NF, f0, fs) if st.NF is not None else 0.0
        return gain, sig

    def scheme_code(st) -> float:
        # 0 = reference (fixed h or phi_max-adaptive), 1 = o4 fixed h,
        # 2 = o4 self-tuning, 3 = local_error
        if st.method == "o4":
            return 1.0 if st.h is not None else 2.0
        if st.method == "local_error":
            return 3.0
        return 0.0

    i = 0
    while i < len(flat):
        st = flat[i]
        if isinstance(st, FiberSpec):            # incl. DBPSpec
            sgn = -1.0 if isinstance(st, DBPSpec) else 1.0
            pre = 1.0
            if isinstance(st, DBPSpec) and st.undo_gain_dB:
                pre = 10.0 ** (-st.undo_gain_dB / 20.0)
            gain, sig = 1.0, 0.0
            h2 = -1.0
            if i + 1 < len(flat) and isinstance(flat[i + 1], EDFASpec):
                nxt = flat[i + 1]
                gain, sig = edfa_vals(nxt)
                if nxt.BW is not None:
                    # optical BPF: full bandwidth BW -> low-pass BW/2
                    # (reference devices.py:938-941 via 818-822)
                    h2 = float(_h2(nxt.filt_order, nxt.BW / 2))
                i += 1
            push(pre=pre, length=st.length,
                 h=(0.0 if st.h is None else st.h), phi_max=st.phi_max,
                 alpha=sgn * alpha_per_km(st.alpha),
                 beta_2=sgn * st.beta_2, beta_3=sgn * st.beta_3,
                 gamma=sgn * st.gamma, gain=gain, sigma_ase=sig,
                 scheme=scheme_code(st), tol=st.tol, h2_idx=h2)
        elif isinstance(st, EDFASpec):
            gain, sig = edfa_vals(st)
            h2 = (float(_h2(st.filt_order, st.BW / 2))
                  if st.BW is not None else -1.0)
            push(gain=gain, sigma_ase=sig, h2_idx=h2)
        elif isinstance(st, DMSpec):
            # H = exp(j w_ps^2 D/2) == a 1 km linear-only span with
            # beta_2 = D (fiber linear phase (beta_2/2) w_ps^2 * h)
            push(length=1.0, h=1.0, beta_2=st.D)
        elif isinstance(st, BPFSpec):
            # zero-length segment applying only the |H|^2 response
            # (reference devices.py:788-826: low-pass cutoff BW/2)
            push(h2_idx=float(_h2(st.n, st.BW / 2)))
        else:
            raise ValueError(f"unsupported pipeline stage {st!r}")
        i += 1

    params = {k: np.asarray(v, np.float64) for k, v in cols.items()}
    bank = (np.stack(h2_bank) if h2_bank
            else np.zeros((0, n), np.float32))
    return params, bool(np.any(params["sigma_ase"] > 0)), bank


class _Segments:
    """Segments ``[first, first + K)`` of a lowered chain on one rank: their
    float32 parameters, dispersion phases and ``|H|^2`` responses on the
    device, and the linear factors of the fixed step sizes (built once: a
    factor is a function of the phase, the loss and ``h``, so the cached
    one is bit-equal to one built a step)."""

    def __init__(self, params, h2_bank, n: int, fs: float, first: int,
                 K: int, device):
        self.p = {k: v.astype(np.float32) for k, v in params.items()}
        self.first, self.K, self.device = first, K, device
        self.ase_index = np.cumsum(params["sigma_ase"] > 0) - 1
        w_ps = 2 * np.pi * np.fft.fftfreq(n) * fs * 1e-12  # rad/ps
        self.w2 = torch.as_tensor((w_ps ** 2).astype(np.float32),
                                  device=device)
        self.w3 = torch.as_tensor((w_ps ** 3).astype(np.float32),
                                  device=device)
        self.h2 = {int(k): torch.as_tensor(h2_bank[int(k)], device=device)
                   .to(torch.complex64)
                   for k in self.p["h2_idx"][first:first + K] if k >= 0}
        self._phi, self._E = {}, {}

    def phi(self, b2: np.float32, b3: np.float32) -> torch.Tensor:
        """phi_w = (beta_2/2) w^2 + (beta_3/6) w^3 in float32 from the
        float32 w^2, w^3 (the JAX segment solvers' in-graph phase)."""
        key = (float(b2), float(b3))
        if key not in self._phi:
            ph = self.w2 * float(b2 * f32(0.5))
            if b3 != 0:
                ph = ph + self.w3 * float(b3 * f32(1.0 / 6.0))
            self._phi[key] = ph
        return self._phi[key]

    def factor(self, phi_w, key, alpha: np.float32, h: np.float32):
        k = key + (float(alpha), float(h))
        if k not in self._E:
            self._E[k] = _lin_factor(phi_w, alpha, h)
        return self._E[k]

    def run(self, x: torch.Tensor, m: int, seed: int, noise):
        """This rank's segments, back to back, on microbatch ``m``."""
        for s in range(self.first, self.first + self.K):
            x = self.segment(x, s, m, seed, noise)
        return x

    def segment(self, x, s, m, seed, noise):
        """Segment ``s`` on microbatch ``m``: pre-scale, split-step solve,
        gain, ASE, ``|H|^2``, each where the segment has it (a zero-length
        segment takes no step; a gain of 1 and no ASE add nothing, as the
        JAX package's multiply by 1 and add of 0 change no value)."""
        p = {k: v[s] for k, v in self.p.items()}
        if p["pre"] != 1:
            x = x * float(p["pre"])
        if p["length"] > 0:
            x = self.ssfm(x, p)
        if p["gain"] != 1:
            x = x * float(p["gain"])
        if p["sigma_ase"] > 0:
            shape = (4, x.shape[-1])
            dr = gaussian(shape, p["sigma_ase"],
                          None if noise is not None else
                          keyed_generator(self.device, seed, m, s),
                          None if noise is None else
                          as_draw(noise[m][int(self.ase_index[s])],
                                  self.device))
            x = x + torch.complex(dr[:2], dr[2:])
        if p["h2_idx"] >= 0:
            # the per-stage zero-phase |H|^2 (EDFA BW / BPF), after gain and
            # ASE as in the fused link
            x = torch.fft.ifft(kernels.cmul(torch.fft.fft(x, dim=-1),
                                            self.h2[int(p["h2_idx"])]),
                               dim=-1)
        return x

    def ssfm(self, x, p):
        """One segment's split-step solve by its scheme code."""
        key = (float(p["beta_2"]), float(p["beta_3"]))
        phi_w = self.phi(p["beta_2"], p["beta_3"])
        L, a, g = p["length"], p["alpha"], p["gamma"]
        scheme = int(p["scheme"])
        if scheme in (2, 3):
            auto = ssfm_o4_auto_inside if scheme == 2 else \
                ssfm_local_error_inside
            return auto(x, phi_w, L, g, p["tol"], L / f32(10.0), a)[0]
        # JAX's segment step rule: h chosen at each step start (fixed, or
        # phi_max-adaptive from the current field), then min(h, L - z) and
        # the float32 floor
        fixed = scheme == 1 or p["h"] > 0
        h_floor = max(L, f32(1.0)) * f32(1.5e-7)
        z, steps = f32(0.0), 0
        with np.errstate(divide="ignore"):
            while z < L and steps < _MAX_STEPS:
                if fixed:
                    h = p["h"]
                else:
                    maxP = max_power(x) if g != 0 else f32(0.0)
                    h = min(p["phi_max"] / max(abs(g) * maxP, f32(1e-30)),
                            L)
                h = max(min(h, L - z), h_floor)
                if scheme == 1:
                    h1, h0 = h * f32(_W1), h * f32(_W0)
                    x = _o4_step(x, phi_w, a, h, g,
                                 self.factor(phi_w, key, a, h1),
                                 self.factor(phi_w, key, a, h0))
                else:
                    E = self.factor(phi_w, key, a, h) if fixed else None
                    x = _nl_l_nl_step(x, phi_w, a, h, g, E=E)
                z = z + h
                steps += 1
        return x


def pipeline_stages_core(mesh, fs: float, stages, n: int, B: int,
                         f0: Optional[float] = None,
                         span_axis: str = "span"):
    """Build the runner of :func:`span_pipeline_stages` for this rank —
    factored out so the pipelined link
    (:class:`opticomlib_tpu_torch.link_pipeline.PipelinedLinkProgram`)
    runs its channel through it.

    Returns ``(run, any_ase, pol_shape)``: ``run(feed, seed, noise=None)``
    maps this rank's ``(B/S,) + pol_shape`` complex64 microbatches to the
    same rows after the whole segment chain.  ``seed`` keys the ASE;
    ``noise[m]``: microbatch ``m``'s ``(4, n)`` unit draws, one a segment
    with ASE in segment order (a link's noise dicts hold them under
    ``"ase"``).  The runner keeps its phases, responses and linear factors,
    so a seed sweep reuses them."""
    ax = mesh.axis(span_axis)
    S = ax.size
    if B % S:
        raise ValueError(
            f"batch size {B} must be a multiple of the span count {S}")
    params, any_ase, h2_bank = _stage_segments(stages, fs, f0, n)
    n_seg = params["length"].size
    if n_seg == 0:
        raise ValueError("stages resolve to zero pipeline segments")
    if n_seg % S:
        raise ValueError(
            f"{n_seg} segments not a multiple of the span count {S}; "
            "pad with RepeatSpec/identity stages or change the mesh")
    K = n_seg // S
    segs = _Segments(params, h2_bank, n, fs, ax.index * K, K, mesh.device)
    pol_shape = (2, n) if any_ase else (n,)

    def run(feed: torch.Tensor, seed: int = 0, noise=None) -> torch.Tensor:
        if tuple(feed.shape[1:]) != pol_shape:
            raise ValueError(f"microbatches of shape {tuple(feed.shape[1:])}"
                             f", the chain needs {pol_shape}")
        return _run_schedule(
            lambda x, m: segs.run(x, m, seed, noise), feed, mesh, span_axis,
            B)

    return run, any_ase, pol_shape


@torch.no_grad()
def span_pipeline_stages(A_batch, mesh, fs: float, stages,
                         f0: Optional[float] = None, seed: int = 0,
                         span_axis: str = "span",
                         noise=None) -> ShardedField:
    """Pipeline a batch of ``B`` waveforms through a **heterogeneous**
    LinkSpec stage chain distributed over the 'span' axis of ``mesh``.

    ``stages``: ``FiberSpec`` / ``DBPSpec`` (optionally followed by an
    ``EDFASpec`` merged into the same segment), standalone ``EDFASpec``,
    ``DMSpec``, ``BPFSpec`` and ``RepeatSpec`` blocks (expanded).  The
    flattened segment count must be a multiple of the span count ``S``;
    rank ``d`` owns segments ``[d*K, (d+1)*K)`` and runs them back to back
    (config 4's 20 x FIBER+EDFA + 20 x DBP chain on 8 ranks: 5 a rank).

    2-pol ASE: when any segment amplifies with ``NF`` set, the batch is
    promoted to ``(B, 2, n)`` at entry and the ASE of microbatch ``m`` in
    segment ``s`` is drawn from a generator keyed by ``(seed, m, s)``, so
    the result does not depend on the schedule (``noise``: see
    :func:`pipeline_stages_core`).

    ``A_batch``: ``(B, n)`` complex (every rank passes the whole batch, or
    a ``ShardedField`` over the axis).  Returns a ``(B, n)`` — or ``(B, 2,
    n)`` when ASE promoted — complex64 ``ShardedField`` over ``span_axis``
    (rank ``d`` holds rows ``[d*B/S, (d+1)*B/S)``)."""
    feed = _local_rows(A_batch, mesh, span_axis)
    B = feed.shape[0] * mesh.axis(span_axis).size
    n = feed.shape[-1]
    run, any_ase, pol_shape = pipeline_stages_core(
        mesh, fs, stages, n=n, B=B, f0=f0, span_axis=span_axis)
    if any_ase:
        feed = torch.stack([feed, torch.zeros_like(feed)], dim=1)
    out = run(feed, seed, noise)
    return ShardedField(out, mesh, (B,) + pol_shape, span_axis, None)
