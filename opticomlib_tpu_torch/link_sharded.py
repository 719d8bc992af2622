"""The sharded fused link: the whole TX -> channel -> RX chain over a mesh of
ranks, each waveform spread over the ranks of the mesh's time axis (port of
``opticomlib_tpu.link_sharded`` to ``torch.distributed``).

It is the fused program of :mod:`opticomlib_tpu_torch.link` on the sharded
runtime of :mod:`opticomlib_tpu_torch.parallel`:

* the **time (sample) axis** is split over the ``'time'`` axis of the mesh;
  every full-length spectral operation (the DAC's pulse shaping, the
  split-step linear steps, the DM and BPF multiplies, the photodiode's
  low-pass) runs through the exact distributed pencil FFT
  (:mod:`opticomlib_tpu_torch.parallel.dfft`, two all-to-all a transform);
* the **WDM channel axis** rides the ``'wdm'`` axis data-parallel;
* the receivers (eye metrology on a small window gathered over 'time',
  threshold scan, slicer, error count) run on each rank for its channels,
  and only the per-channel scalars are gathered, so every rank returns the
  same ``(n_channels,)`` vectors.

One process is one rank; every rank of the mesh makes the same calls (SPMD),
with the whole inputs (bits, seeds), and keeps its block.  The chain (TX, the
stages, the fiber dispatch, PD/LPF/ADC) is the one-device program's,
:class:`opticomlib_tpu_torch.link._LinkChain`, on this rank's ``(lc, B)``
block; this module supplies what differs: the pencil spectral multiply, the
per-channel reductions all-reduced over 'time', the keyed draws, the ADC's
range and the per-channel adaptive loop.  On each block the kicks are
``kernels.nl_halfstep``, the spectral and twiddle products ``kernels.cmul``,
the receivers' histograms ``kernels.histogram_rows`` and the ADC
``kernels.adc_quantize_link``, as on one card.

Design notes (those of the JAX module, and what differs):

* **Spectral constants in strided layout.**  After ``pencil_fft`` rank
  ``q`` of ``P`` holds the bins ``q + P*k2``.  The host-designed responses
  (pulse spectrum, Bessel ``|H|^2``) are permuted once and each rank keeps
  its block as a buffer (complex64, the operand of ``cmul``).  Dispersion
  phases are evaluated per rank on the strided grid in float32, as the JAX
  program evaluates them in-graph (``strided_dispersion_phase``).
* **Noise is block-local.**  Each rank draws its block from a
  ``torch.Generator`` keyed by (seed + channel, noise stage, time index):
  reproducible on one mesh, a different stream from the unsharded program
  and from JAX's threefry keys.  The laser's Wiener walk is a local float32
  running sum plus the all-gathered sums of the blocks before it.
  ``noise=`` (a list of per-channel dicts of global unit-normal draws, as
  :meth:`LinkProgram.forward` takes them) replaces the draws: each rank
  takes its block, and the program then equals the unsharded one on the
  same draws to float32 round-off.
* **Adaptive stepping** (``FiberSpec(h=None)``) keeps the reference
  ``phi_max`` criterion per channel: one loop advances every local channel
  with its own step size (``z``, ``h`` and a live mask are ``(lc,)``
  vectors); each channel's ``max|A|^2`` is all-reduced (max) over 'time'
  before its one read-back a step, so every rank of a time line takes the
  same steps; finished channels stay as they are.  The self-tuning schemes
  (``o4``/``local_error``, ``h=None``) step all local channels jointly,
  their error norms summed over 'time'.
"""
from __future__ import annotations

import itertools
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .eyediag import Eye
from .link import (LinkProgram, LinkSpec, _circular_zero_phase_spectrum,
                   _gathered_rows, _hdd_uniform, _LinkChain, _ook_sweep_rows,
                   _ppm_result, _ppm_shape, _ppm_sweep_rows, _pulse_taps,
                   _stage_plan, _sweep_bits, _sweep_result, _warn_rin)
from .models.ppm import PPM_ENCODER
from .ops import filters, kernels
from .ops.eyeana import eye_window, shortest_int_hist
from .ops.noise import as_draw, gaussian, keyed_generator, running_sum
from .ops.prbs import prbs
from .ops.ssfm import (_MAX_STEPS, _first_step, _lin_factor, _next_step,
                       _phi_step)
from .parallel.dfft import (pencil_fft, pencil_ifft, strided_dispersion_phase,
                            strided_w_grid)
from .parallel.fiber import ShardedField
from .params import SimParams

__all__ = ["ShardedLinkProgram"]

f32 = np.float32


def _strided_permute(H: np.ndarray, P_: int) -> np.ndarray:
    """Permute a natural-FFT-order response of length ``n = P*B`` into the
    pencil strided layout: the ``q``-th contiguous block of the result is
    ``H[q + P*k2]`` for ``k2 in [0, B)``, rank ``q``'s local spectrum slice
    after ``pencil_fft`` (copied from ``opticomlib_tpu.link_sharded``)."""
    n = H.shape[-1]
    B = n // P_
    return np.ascontiguousarray(H.reshape(B, P_).T).reshape(n)


def _noisy_edfas(plan) -> int:
    """The noisy EDFAs a stage plan runs, ``RepeatSpec`` blocks unrolled."""
    return sum(cc["n"] * _noisy_edfas(cc["sub"]) if cc["kind"] == "repeat"
               else "sigma_ase" in cc for cc in plan)


class ShardedLinkProgram(_LinkChain):
    """A fused link over a mesh of ranks.  The surface of the JAX
    ``ShardedLinkProgram``: :meth:`jitted` (the chain, sharded outputs),
    :meth:`run` (the waveforms gathered to the host, for small ``n``),
    :meth:`dsp` (the OOK receiver, scalars only), :meth:`dsp_wdm` (a
    receiver a channel over the 'wdm' axis) and :meth:`dsp_wdm_ppm`.

    ``mesh``: a :class:`~opticomlib_tpu_torch.parallel.fiber.LinkMesh` with a
    ``time_axis`` and, optionally, a ``wdm_axis`` (a name the mesh lacks
    means none).  Its spectral constants are buffers named as the JAX
    program names its constants (``Hp``, ``H2_pd``, ``H2_bpf_<k>``,
    ``df_phase``), this rank's block of each, on the mesh's device.  The
    chain is :class:`~opticomlib_tpu_torch.link.LinkProgram`'s, on this
    rank's channels and time block."""
    _lead = 1

    def __init__(self, spec: LinkSpec, n_bits: int, params: SimParams,
                 mesh, time_axis: str = "time",
                 wdm_axis: Optional[str] = "wdm",
                 return_field: bool = False):
        super().__init__()
        self.spec = spec
        self.n_bits = int(n_bits)
        self.params = params
        self.mesh = mesh
        self.time_axis = time_axis
        self._t = mesh.axis(time_axis)
        if wdm_axis is not None and wdm_axis not in mesh.axis_names:
            wdm_axis = None
        self.wdm_axis = wdm_axis
        self.return_field = bool(return_field)
        self.device = mesh.device

        sps = params.sps
        self.n = n = self.n_bits * sps
        fs = params.fs
        self.n_time = P_t = self._t.size
        self.n_wdm = mesh.size(wdm_axis)
        if self.n_bits % P_t:
            raise ValueError(f"n_bits {n_bits} not divisible by the "
                             f"'{time_axis}' mesh size {P_t}")
        block = n // P_t
        if block % P_t:
            raise ValueError(
                f"pencil FFT needs n divisible by n_time^2: n={n}, "
                f"n_time={P_t} (block {block} % {P_t} != 0)")
        if block % sps:
            raise ValueError("block must hold whole slots")
        self.block = block
        q = self._t.index
        mine = slice(q * block, (q + 1) * block)

        def strided(H):  # this rank's block of a response, strided layout
            return _strided_permute(np.asarray(H), P_t)[mine].astype(
                np.complex64)

        self._buffer("Hp", strided(_circular_zero_phase_spectrum(
            _pulse_taps(spec, sps), n)))
        self._buffer("H2_pd", strided(filters.bessel_filtfilt_response(
            spec.lpf_order, float(spec.pd_BW), fs, n)))
        names = {}

        def bpf_name(order: int, BW: float) -> str:
            key = (order, float(BW))
            if key not in names:
                names[key] = f"H2_bpf_{len(names)}"
                self._buffer(names[key], strided(
                    filters.bessel_filtfilt_response(order, float(BW) / 2,
                                                     fs, n)))
            return names[key]

        self.plan = _stage_plan(spec.stages, params.f0, fs,
                                fiber_extra=lambda st: {},
                                dm_const=lambda st: {"D": float(st.D)},
                                bpf_name=bpf_name)

        # per-rank spectral factors evaluated on the strided grid, as the
        # JAX program evaluates them in-graph (not constants it holds)
        self._phi, self._dm = {}, {}
        w_ps = strided_w_grid(q, P_t, block, fs, self.device) * 1e-12

        def grids(stages, plan):
            for st, cc in zip(stages, plan):
                if cc["kind"] == "fiber":
                    key = (cc["sgn"] * st.beta_2, cc["sgn"] * st.beta_3)
                    if key not in self._phi:
                        self._phi[key] = strided_dispersion_phase(
                            q, P_t, block, fs, *key, self.device)
                elif cc["kind"] == "dm" and cc["D"] not in self._dm:
                    ph = w_ps * w_ps * cc["D"] / 2
                    self._dm[cc["D"]] = torch.complex(torch.cos(ph),
                                                      torch.sin(ph))
                elif cc["kind"] == "repeat":
                    grids(st.stages, cc["sub"])

        grids(spec.stages, self.plan)
        self._n_ase = _noisy_edfas(self.plan)
        # a time-domain constant: rank q keeps its contiguous samples
        self._set_scalars(mine)

    _buffer = LinkProgram._buffer
    load_consts = LinkProgram.load_consts

    # ---- collectives over the time axis ----
    def _time(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return self.mesh.all_reduce(x, op, self.time_axis)

    # ---- what the chain asks of a rank ----
    def _spectral(self, x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """The global spectral multiply: pencil FFT, ``cmul`` by ``H`` (this
        rank's strided block, broadcast over the leading axes), inverse; a
        real ``x`` gives the real part."""
        if not x.is_complex():
            return self._spectral(x.to(torch.complex64), H).real
        return pencil_ifft(kernels.cmul(pencil_fft(x, self._t), H), self._t)

    _ssfm_spectral = _spectral

    def _ssfm_sum(self, s: torch.Tensor) -> torch.Tensor:
        return self._time(s, "sum")

    def _over_time(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return self._time(x.mean(dim=-1, keepdim=True) if op == "mean"
                          else x.amin(dim=-1, keepdim=True), op)

    def _fiber_phase(self, st, cc: dict, neg_phi: dict) -> torch.Tensor:
        return self._phi[(cc["sgn"] * st.beta_2, cc["sgn"] * st.beta_3)]

    def _dm_factor(self, cc: dict) -> torch.Tensor:
        return self._dm[cc["D"]]

    def _adc(self, v: torch.Tensor, bits: int) -> torch.Tensor:
        """The 99.99 % shortest interval from histograms summed over the
        time axis (no global sort), then the link-mode ADC kernel a
        channel."""
        lo, hi = shortest_int_hist(
            v, 99.99, reduce_sum=lambda t: self._time(t, "sum"),
            reduce_min=lambda t: self._time(t, "min"),
            reduce_max=lambda t: self._time(t, "max"))
        return torch.stack([kernels.adc_quantize_link(v[c], lo[c], hi[c], bits)
                            for c in range(v.shape[0])])

    def _time_gather(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """The first ``width`` samples of this rank's rows of ``x`` (its
        block of ``(rows, n)``), whole: gathered along the time axis."""
        m = min(x.shape[-1], width)
        parts = self.mesh.all_gather(x[..., :m].contiguous(), self.time_axis)
        return torch.cat(list(parts[:-(-width // m)]), dim=-1)[..., :width]

    # ---- noise ----
    def _draws(self, seeds, stage: int, shape, sigma, noise, name, i=None):
        """``sigma * N(0, 1)`` draws, ``(lc,) + shape``, for this rank's
        channels and time block: from ``noise[c][name]`` (``[i]``) where
        given, else from a generator keyed by (seed, stage, time index).
        ``sigma``: a float, or a ``(lc,)`` tensor of one a channel."""
        q, B = self._t.index, self.block
        out = []
        for c, seed in enumerate(seeds):
            s = sigma.reshape(-1)[c] if isinstance(sigma, torch.Tensor) \
                else sigma
            if noise is None:
                out.append(gaussian(shape, s, keyed_generator(
                    self.device, seed, stage, q)))
                continue
            d = as_draw(noise[c][name] if i is None else noise[c][name][i],
                        self.device)
            out.append(gaussian(shape, s, None, d[..., q * B:(q + 1) * B]))
        return torch.stack(out)

    def _noise(self, seeds, noise):
        """The chain's draws (``walk``, ``normal``, ``ase``; see
        :class:`~opticomlib_tpu_torch.link._LinkChain`) for this rank's
        channels and time block, keyed by (seed, stage, time index): stage
        0 the laser phase, 1 RIN, 2, 3, ... the noisy EDFAs in the order
        they run, then thermal and shot noise, each key whether or not its
        draw is taken."""
        B = self.block
        keys = {"phase": 0, "rin": 1, "thermal": 2 + self._n_ase,
                "shot": 3 + self._n_ase}
        i_ase = itertools.count()

        def normal(name, sigma):
            return self._draws(seeds, keys[name], (B,), sigma, noise, name)

        def ase(sigma):
            i = next(i_ase)
            return self._draws(seeds, 2 + i, (4, B), sigma, noise, "ase", i)

        def walk(sigma):
            steps = normal("phase", sigma)
            # the walk so far: the sums of the blocks before this one
            totals = self.mesh.all_gather(steps.sum(dim=-1), self.time_axis)
            return (running_sum(steps)
                    + totals[:self._t.index].sum(dim=0)[:, None])
        return walk, normal, ase

    # ---- the chain on this rank's block ----
    def _core(self, bits_blk: torch.Tensor, seeds, noise=None):
        """``bits_blk``: ``(lc, bits_block)`` float32, this rank's channels
        and slots; ``seeds``: one int a local channel; ``noise``: their draw
        dicts or ``None``.  Returns this rank's blocks ``(v, slots)``, the
        step counts ``(lc, fiber stages run)``, the field before the
        photodiode and the ``rin_ok`` flags ``(lc,)``."""
        lc = bits_blk.shape[0]
        walk, normal, ase = self._noise(seeds, noise)
        v, n_steps, field, rin_ok = self._chain(
            lambda: self._launch(bits_blk, walk, normal), ase, normal)
        steps = torch.as_tensor(
            np.stack([np.broadcast_to(s, lc) for s in n_steps], axis=1)
            if n_steps else np.zeros((lc, 0), np.int64), device=self.device)
        return (v, v[:, self.instant::self.params.sps].contiguous(), steps,
                field, rin_ok)

    def _adaptive(self, A, phi, st, g_nl, a_lin):
        """phi_max-adaptive split-step with a step size a channel: ``z`` and
        ``h`` are ``(lc,)`` float32 vectors, the live channels take a step
        together (a kick and a spectral factor a channel, one pencil
        transform for all), finished channels stay as they are.  Each
        channel's ``max|A|^2`` is all-reduced (max) over the time axis
        before the step's one read-back, so every rank of a time line takes
        the same steps.  A channel's step sizes are those the single-channel
        loop (``ops.ssfm.ssfm_while_inside``) takes: the same step rule.
        Returns ``(A, (lc,) step counts)``."""
        g32, a32, L = f32(g_nl), f32(a_lin), f32(st.length)
        lc = A.shape[0]

        def ch_max_power():
            m = torch.view_as_real(A).square().sum(-1).reshape(lc, -1)
            return self._time(m.amax(dim=-1), "max").cpu().numpy()

        z = np.zeros(lc, f32)
        steps = np.zeros(lc, np.int64)
        h = _first_step(st.phi_max, g32, ch_max_power(), L)
        with np.errstate(divide="ignore"):
            for _ in range(_MAX_STEPS):
                live = np.flatnonzero(z < L)
                if not len(live):
                    break
                z[live] = z[live] + h[live]
                rows = (None if len(live) == lc
                        else torch.as_tensor(live, device=A.device))
                sub = A if rows is None else A.index_select(0, rows)
                B, H = torch.empty_like(sub), torch.empty_like(sub)
                for r, c in enumerate(live):
                    kernels.nl_halfstep(sub[r], g32 * (h[c] / f32(2)),
                                        out=(B[r], H[r]))
                X = pencil_fft(B, self._t)
                for r, c in enumerate(live):
                    kernels.cmul(X[r], _lin_factor(phi, a32, h[c]), out=X[r])
                y = kernels.cmul(pencil_ifft(X, self._t), H)
                if rows is None:
                    A = y
                else:
                    A.index_copy_(0, rows, y)
                steps[live] += 1
                h = _next_step(_phi_step(st.phi_max, g32, ch_max_power()),
                               L, z)
        return A, steps

    # ---- inputs and outputs ----
    def _place(self, bits, seeds, noise):
        """This rank's share of global inputs: the number of channels, the
        first local channel, the ``(lc, bits_block)`` bits block on the
        mesh's device, the local seeds and noise dicts."""
        if isinstance(bits, torch.Tensor):
            if bits.device.type != self.device.type:
                raise ValueError(
                    f"bits lie on {bits.device}, the mesh computes on "
                    f"{self.device}: pass host data or a tensor there")
            bits = bits.to(torch.float32)
        else:
            bits = torch.from_numpy(np.array(bits, dtype=np.float32))
        if bits.ndim == 1:
            bits = bits[None]
        n_ch = bits.shape[0]
        if self.wdm_axis and n_ch % self.n_wdm:
            raise ValueError(f"{n_ch} channels not divisible by the "
                             f"'{self.wdm_axis}' mesh size {self.n_wdm}")
        if bits.shape[1] != self.n_bits:
            raise ValueError(
                f"need {self.n_bits} bits a channel, got {bits.shape[1]}")
        seeds = np.asarray(seeds).reshape(-1)
        if seeds.size != n_ch or (noise is not None and len(noise) != n_ch):
            raise ValueError(f"need {n_ch} seeds (and noise dicts), one a "
                             "channel")
        lc = n_ch // self.n_wdm
        r0 = self.mesh.index(self.wdm_axis) * lc
        bb = self.n_bits // self.n_time
        q = self._t.index
        blk = bits[r0:r0 + lc, q * bb:(q + 1) * bb].to(
            self.device).contiguous()
        return (n_ch, r0, blk, [int(s) for s in seeds[r0:r0 + lc]],
                None if noise is None else list(noise[r0:r0 + lc]))

    def _sharded(self, local: torch.Tensor, n_ch: int) -> ShardedField:
        shape = (n_ch,) + tuple(local.shape[1:-1]) + (
            local.shape[-1] * self.n_time,)
        return ShardedField(local, self.mesh, shape, self.wdm_axis,
                            self.time_axis)

    @torch.no_grad()
    def jitted(self, bits, seeds, noise: Optional[list] = None):
        """The chain: ``(bits, seeds) -> (v, slots, n_steps[, field],
        rin_ok)``.  Every rank passes the whole inputs, ``bits`` ``(n_ch,
        n_bits)`` (or one channel's ``(n_bits,)``) and ``seeds`` one a
        channel, and keeps its block.  ``v`` ``(n_ch, n)``, ``slots``
        ``(n_ch, n_bits)`` and the field before the photodiode ``(n_ch[,
        2], n)`` (with ``return_field=True``) are
        :class:`~opticomlib_tpu_torch.parallel.fiber.ShardedField` s
        (``np.asarray`` gathers one); ``n_steps`` holds one ``(n_ch,)``
        array a fiber stage run, ``rin_ok`` ``(n_ch,)`` is 0 where a RIN
        draw was clamped: both the same on every rank, in one read-back."""
        n_ch, _, blk, seeds, noise = self._place(bits, seeds, noise)
        v, slots, steps, field, rin_ok = self._core(blk, seeds, noise)
        host = self.mesh.gather_rows(torch.cat(
            [rin_ok[:, None].to(torch.float64), steps.to(torch.float64)],
            dim=1), self.wdm_axis).cpu().numpy()
        out = (self._sharded(v, n_ch), self._sharded(slots, n_ch),
               tuple(host[:, 1 + j].astype(np.int64)
                     for j in range(steps.shape[1])))
        if self.return_field:
            out = out + (self._sharded(field.contiguous(), n_ch),)
        return out + (host[:, 0].astype(np.float32),)

    forward = jitted

    @torch.no_grad()
    def run(self, bits=None, seed: int = 0, prbs_order: int = 15,
            noise: Optional[list] = None):
        """Run the chain and gather ``v`` and ``slots`` to the host on every
        rank (for verification at small ``n``; the receivers stay on the
        devices through :meth:`dsp` / :meth:`dsp_wdm`).  Channel ``c`` has
        the seed ``seed + c``."""
        if bits is None or np.ndim(bits) == 1:
            if self.n_wdm > 1:
                raise ValueError(
                    f"run() with a single channel needs a mesh without a "
                    f"'{self.wdm_axis}' axis (or size 1); this mesh has "
                    f"{self.n_wdm} — pass (k*{self.n_wdm}, n_bits) bits")
        if bits is None:
            bits = prbs(prbs_order, length=self.n_bits)[0]
        bits = np.atleast_2d(np.asarray(bits, np.float32))
        out = self.jitted(bits, np.arange(bits.shape[0]) + seed, noise)
        v, slots = np.asarray(out[0]), np.asarray(out[1])
        rin_ok = out[-1] > 0
        if not rin_ok.all():
            _warn_rin(np.flatnonzero(~rin_ok).tolist())
        one = bits.shape[0] == 1
        return SimpleNamespace(
            v=v[0] if one else v, slots=slots[0] if one else slots,
            tx=bits.astype(np.uint8), n_steps=out[2],
            rin_ok=bool(rin_ok[0]) if one else rin_ok,
            **({"field": np.asarray(out[3])} if self.return_field else {}))

    # ---- receivers ----
    @torch.no_grad()
    def dsp_wdm(self, n_channels: int, bits=None, seed: int = 0,
                prbs_order: int = 15, nslots: int = 8192,
                sps_resamp: Optional[int] = None,
                noise: Optional[list] = None):
        """WDM sweep with the OOK receiver a channel over the mesh: the
        channels over 'wdm', each channel's waveform over 'time' (BASELINE
        config 5 through the public API).  Channel ``c`` has the bits of row
        ``c`` (default: consecutive PRBS segments) and the seed
        ``seed + c``.  Each rank gathers its channels' eye windows and slot
        samples over 'time' and runs :meth:`LinkProgram.dsp_wdm`'s receiver
        on them; the per-channel results come back as ``(n_channels,)``
        vectors on every rank, with ``eye_fields`` (all eye scalars) and
        ``n_steps``."""
        bits = _sweep_bits(bits, n_channels, self.n_bits, prbs_order)
        n_ch, r0, blk, seeds, noise = self._place(
            bits, np.arange(n_channels) + seed, noise)
        v, slots, steps, _, rin_ok = self._core(blk, seeds, noise)
        sps = self.params.sps
        rows, layout, _ = _ook_sweep_rows(
            self._time_gather(v, eye_window(self.n, sps, nslots)),
            self._time_gather(slots, self.n_bits),
            torch.as_tensor(bits[r0:r0 + len(blk)].astype(np.float32),
                            device=self.device),
            sps, nslots, sps_resamp, dict(rin_ok=rin_ok, steps=steps))
        r = _gathered_rows(rows, layout, self.mesh, self.wdm_axis)
        extra = ("rth", "n_err", "rin_ok", "steps")
        return SimpleNamespace(
            threshold=r["rth"].astype(np.float32),
            **{k: r[k] for k in ("mu0", "mu1", "s0", "s1", "er", "eye_h")},
            eye_fields={k: v for k, v in r.items() if k not in extra},
            **_sweep_result(r, n_channels, bits, self.n_bits))

    @torch.no_grad()
    def dsp(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = 128,
            noise: Optional[dict] = None):
        """The fused OOK receiver of one channel: chain -> GET_EYE ->
        THRESHOLD_EST -> slicer -> BER, scalars-only read-back (what
        :meth:`LinkProgram.dsp` returns, ``tx`` as a uint8 array)."""
        if self.n_wdm > 1:
            raise ValueError(
                f"dsp() is single-channel but the mesh has a "
                f"'{self.wdm_axis}' axis of size {self.n_wdm}; use "
                f"dsp_wdm(n_channels=k*{self.n_wdm}) or a mesh with "
                "only a time axis")
        r = self.dsp_wdm(1, bits=None if bits is None else
                         np.asarray(bits).reshape(1, -1), seed=seed,
                         prbs_order=prbs_order, nslots=nslots,
                         sps_resamp=sps_resamp,
                         noise=None if noise is None else [noise])
        eye_kw = {k: (v[0].item() if v[0].ndim == 0 else v[0])
                  for k, v in r.eye_fields.items()}
        for k in ("threshold", "y_left", "y_right"):
            if eye_kw.get(k) is not None and np.isnan(eye_kw[k]):
                eye_kw[k] = None
        eye_kw["sps"] = self.params.sps
        if sps_resamp:
            eye_kw["sps_resamp"] = sps_resamp
        eye_kw["dt"] = 1.0 / self.params.fs
        return SimpleNamespace(
            ber=float(r.ber[0]), n_errors=int(r.n_errors[0]),
            threshold=float(r.threshold[0]), eye=Eye(eye_kw), tx=r.tx[0],
            n_steps=r.n_steps[0], rin_ok=bool(r.rin_ok[0]))

    @torch.no_grad()
    def dsp_wdm_ppm(self, n_channels: int, M: int, decision: str = "soft",
                    bits=None, seed: int = 0, prbs_order: int = 15,
                    nslots: int = 8192, sps_resamp: Optional[int] = None,
                    noise: Optional[list] = None):
        """M-PPM WDM sweep on the mesh, the sharded twin of
        :meth:`LinkProgram.dsp_wdm_ppm`: ``bits`` are the information bits
        ``(n_channels, n_sym*log2(M))``, encoded on the host; soft decisions
        by per-symbol argmax, hard ones by eye metrology on the window
        gathered over 'time', the KDE/scan threshold, the slicer and the
        HDD repair (scores keyed by ``seed + c``, or ``noise[c]["hdd"]``);
        ``n_repaired`` as :meth:`LinkProgram.dsp_wdm_ppm` returns it."""
        decision, k, n_sym = _ppm_shape(self.n_bits, M, decision)
        bits = _sweep_bits(bits, n_channels, n_sym * k,
                           prbs_order).astype(np.uint8)
        slots_tx = np.stack([PPM_ENCODER(bits[c], M).data.astype(np.float32)
                             for c in range(n_channels)])
        n_ch, r0, blk, seeds, noise_l = self._place(
            slots_tx, np.arange(n_channels) + seed, noise)
        v, slots, steps, _, rin_ok = self._core(blk, seeds, noise_l)
        sps = self.params.sps
        wins = (self._time_gather(v, eye_window(self.n, sps, nslots))
                if decision == "hard" else None)
        rows, layout = _ppm_sweep_rows(
            wins, self._time_gather(slots, self.n_bits),
            torch.as_tensor(bits[r0:r0 + len(blk)], device=self.device), M,
            decision, sps, nslots, sps_resamp,
            lambda c: _hdd_uniform(seed + r0 + c, n_sym, M,
                                   None if noise is None else noise[r0 + c],
                                   self.device),
            dict(rin_ok=rin_ok, steps=steps))
        r = _gathered_rows(rows, layout, self.mesh, self.wdm_axis)
        return SimpleNamespace(
            **_ppm_result(r, M, decision),
            **_sweep_result(r, n_channels, bits, n_sym * k))
