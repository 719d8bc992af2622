"""The pipelined fused link: TX, the span-pipelined channel and the fused
receivers over a ``('span',)`` mesh of ranks (port of
``opticomlib_tpu.link_pipeline`` to ``torch.distributed``).

``build_link(spec, n_bits, span_mesh=mesh)`` runs

* **TX** a channel on its owner rank (rank ``d`` owns channels ``[d*C,
  (d+1)*C)``, ``C = n_channels / S``): the transmitter of the stages-less
  twin of the fused program (DAC -> laser -> MZM/PM), with channel ``c``'s
  laser draws those of ``LinkProgram.dsp_wdm`` (a generator seeded
  ``seed + c``);
* the **channel** through :func:`~opticomlib_tpu_torch.parallel.pipeline.
  pipeline_stages_core`: rank ``d`` runs segments ``[d*K, (d+1)*K)`` of the
  flattened FIBER/DBP/EDFA/DM/BPF chain, the channels streaming through as
  microbatches, the 2-pol ASE keyed by (seed, channel, segment);
* the **RX** on each owner rank: the twin's receiver (photodiode with
  thermal and shot noise from a generator keyed by ``(seed + c, 0x5044)``
  -> zero-phase Bessel LPF -> the optional ADC), then the OOK or M-PPM
  receivers of all its channels at once (one ``histogram_rows`` launch);
  the per-channel scalars are gathered over the mesh, so every rank returns
  all ``n_channels``.

The kicks are ``kernels.nl_halfstep``, the segments' spectral multiplies
and ``|H|^2`` responses ``kernels.cmul``, the ADC
``kernels.adc_quantize_link``, as on one card.

Noise streams: the ASE and photodiode draws differ from the fused program's
sequential stream (same physics); one seed gives one result whatever the
span count.  ``noise=`` takes a list of per-channel dicts of unit draws, the
fused program's format (``"phase"``, ``"rin"``, ``"ase"`` one ``(4, n)``
array a segment with ASE, ``"thermal"``, ``"shot"``, ``"hdd"``), so the
tests feed both packages the same numbers.
"""
from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .link import (LinkProgram, LinkSpec, _gathered_rows, _hdd_uniform,
                   _injected, _ook_sweep_rows, _ppm_result, _ppm_shape,
                   _ppm_sweep_rows, _sweep_bits, _warn_rin)
from .models.ppm import PPM_ENCODER
from .ops.eyeana import eye_window
from .ops.noise import gaussian, keyed_generator
from .params import SimParams
from .parallel.pipeline import pipeline_stages_core

__all__ = ["PipelinedLinkProgram"]



class PipelinedLinkProgram(torch.nn.Module):
    """A fused link whose channel stages run pipelined over a span mesh.

    :meth:`dsp_wdm` (OOK) and :meth:`dsp_wdm_ppm` run ``n_channels`` (a
    multiple of the span count) independent TX -> RX chains whose channel
    propagation streams through the pipeline; every rank of the mesh makes
    the same call and gets the per-channel scalars of all channels.  The
    constants are the twin's buffers (``Hp``, ``H2_pd``, ``df_phase``), on
    the mesh's device; :meth:`load_consts` takes the JAX program's
    ``consts`` through ``convert.consts_from_jax``."""

    def __init__(self, spec: LinkSpec, n_bits: int, params: SimParams,
                 mesh, span_axis: str = "span"):
        super().__init__()
        self.spec = spec
        self.n_bits = int(n_bits)
        self.params = params
        self.mesh = mesh
        self.span_axis = span_axis
        self.S = mesh.axis(span_axis).size
        self.n = self.n_bits * params.sps
        self.device = mesh.device
        # the stages-less fused program: its transmitter and its receiver
        # run on each channel's owner, around the pipelined stages
        self._tx = LinkProgram(replace(spec, stages=()), n_bits, params,
                               self.device)
        self.instant = self._tx.instant
        self._dsp_cache = {}

    def load_consts(self, consts: dict) -> None:
        """Replace the twin's constants (the JAX program's ``consts``, its
        TX twin's, through ``convert.consts_from_jax``)."""
        self._tx.load_consts(consts)

    # ---- the chain ----
    def _runner(self, n_channels: int):
        """The pipeline runner for ``n_channels`` microbatches, built once:
        a seed sweep reuses it."""
        if n_channels not in self._dsp_cache:
            self._dsp_cache[n_channels] = pipeline_stages_core(
                self.mesh, self.params.fs, self.spec.stages, n=self.n,
                B=n_channels, f0=self.params.f0, span_axis=self.span_axis)
        return self._dsp_cache[n_channels]

    def _channels(self, n_channels: int) -> range:
        if n_channels < 1 or n_channels % self.S:
            raise ValueError(
                f"n_channels must be a positive multiple of the span "
                f"count {self.S}, got {n_channels}")
        C = n_channels // self.S
        d = self.mesh.axis(self.span_axis).index
        return range(d * C, (d + 1) * C)

    def _chain(self, inputs, seed: int, noise, nslots: int, mine: range):
        """TX of this rank's channels, the pipeline over all ranks, RX of
        this rank's channels.  Returns the stacked eye windows and slot
        samples ``(C, ...)`` and the ``rin_ok`` flags ``(C,)``."""
        if noise is not None and len(noise) != len(inputs):
            raise ValueError(
                f"noise must be a list of {len(inputs)} per-channel dicts")
        sps, n, dev = self.params.sps, self.n, self.device
        run, any_ase, _ = self._runner(len(inputs))
        fields, flags = [], []
        for c in mine:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed + c))
            f, ok = self._tx._transmit(
                torch.as_tensor(inputs[c], dtype=torch.float32, device=dev),
                gen, _injected(None if noise is None else noise[c], dev))
            fields.append(f)
            flags.append(ok)
        feed = torch.stack(fields)
        del fields
        if any_ase:
            feed = torch.stack([feed, torch.zeros_like(feed)], dim=1)
        out = run(feed, seed,
                  None if noise is None else [d.get("ase") for d in noise])
        del feed
        w = eye_window(n, sps, nslots)
        wins, slots = [], []
        for j, c in enumerate(mine):
            draw = _injected(None if noise is None else noise[c], dev)
            gen = (None if noise is not None
                   else keyed_generator(dev, seed + c, 0x5044))
            v = self._tx._receive(out[j], lambda name, sigma: gaussian(
                (n,), sigma, gen, draw(name)))
            wins.append(v[:w].clone())
            slots.append(v[self.instant::sps].clone())
        return torch.stack(wins), torch.stack(slots), torch.stack(flags)

    # ---- receivers ----
    @torch.no_grad()
    def dsp_wdm(self, n_channels: int, bits=None, seed: int = 0,
                prbs_order: int = 15, nslots: int = 8192,
                sps_resamp: Optional[int] = None,
                noise: Optional[list] = None):
        """WDM sweep with the channel stages pipelined over the span mesh:
        ``n_channels`` (a multiple of the span count) chains, channel ``c``
        with the bits of row ``c`` (default: consecutive PRBS segments) and
        the seed ``seed + c``, and the OOK receiver of
        :meth:`LinkProgram.dsp_wdm`; the per-channel scalars come back on
        every rank (the pipelined twin of ``LinkProgram.dsp_wdm``, plus the
        ``rin_ok`` flags).  ``noise``: a list of per-channel draw dicts."""
        mine = self._channels(n_channels)
        bits = _sweep_bits(bits, n_channels, self.n_bits, prbs_order)
        wins, slots, flags = self._chain(bits, seed, noise, nslots, mine)
        rows, layout, _ = _ook_sweep_rows(
            wins, slots, torch.as_tensor(bits[mine].astype(np.float32),
                                         device=self.device),
            self.params.sps, nslots, sps_resamp, dict(rin_ok=flags))
        r = _gathered_rows(rows, layout, self.mesh, self.span_axis)
        return SimpleNamespace(
            threshold=r["rth"].astype(np.float32),
            **{k: r[k] for k in ("mu0", "mu1", "s0", "s1", "er", "eye_h")},
            **self._result(r, n_channels, bits, self.n_bits))

    @torch.no_grad()
    def dsp_wdm_ppm(self, n_channels: int, M: int, decision: str = "soft",
                    bits=None, seed: int = 0, prbs_order: int = 15,
                    nslots: int = 8192, sps_resamp: Optional[int] = None,
                    noise: Optional[list] = None):
        """M-PPM WDM sweep with the channel stages pipelined: the PPM twin
        of :meth:`dsp_wdm` (soft: per-symbol argmax; hard: eye metrology on
        the stacked windows, the KDE/scan threshold, the slicer and the HDD
        repair scored by ``seed + c`` or ``noise[c]["hdd"]``).  ``bits``:
        the information bits ``(n_channels, n_sym*log2(M))``;
        ``n_repaired`` as :meth:`LinkProgram.dsp_wdm_ppm` returns it."""
        decision, k, n_sym = _ppm_shape(self.n_bits, M, decision)
        mine = self._channels(n_channels)
        bits = _sweep_bits(bits, n_channels, n_sym * k,
                           prbs_order).astype(np.uint8)
        slots_tx = np.stack([PPM_ENCODER(bits[c], M).data.astype(np.float32)
                             for c in range(n_channels)])
        wins, slots, flags = self._chain(slots_tx, seed, noise, nslots, mine)
        rows, layout = _ppm_sweep_rows(
            wins, slots, torch.as_tensor(bits[mine], device=self.device), M,
            decision, self.params.sps, nslots, sps_resamp,
            lambda j: _hdd_uniform(
                seed + mine[j], n_sym, M,
                None if noise is None else noise[mine[j]], self.device),
            dict(rin_ok=flags))
        r = _gathered_rows(rows, layout, self.mesh, self.span_axis)
        return SimpleNamespace(
            **_ppm_result(r, M, decision),
            **self._result(r, n_channels, bits, n_sym * k))

    @staticmethod
    def _result(r: dict, n_channels: int, bits, per_channel_bits: int):
        n_err = r["n_err"].astype(np.int64)
        rin_ok = r["rin_ok"] > 0
        if not rin_ok.all():
            _warn_rin(np.flatnonzero(~rin_ok).tolist())
        return dict(ber=n_err / per_channel_bits, n_errors=n_err,
                    n_channels=n_channels, tx=bits.astype(np.uint8),
                    rin_ok=rin_ok)
