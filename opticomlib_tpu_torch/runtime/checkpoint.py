"""Checkpoint/resume for long fiber propagations (port of
``opticomlib_tpu.runtime.checkpoint``).

State = (z position [km], planar field (re, im), physics config hash,
monotonic step counter).  Saves are atomic (write-to-temp + rename) so a
crash mid-save never corrupts the latest checkpoint, and each save is a
separate file so the *previous* checkpoint survives a crash too.  The
arrays are NumPy ``npz`` files of the same layout as the JAX package
writes, and the config fingerprint is computed the same way, so a file
written by either package's :class:`PropagationCheckpointer` loads in the
other, and a run begun by one ``ssfm_propagate_resumable`` resumes in the
other.

Checkpoints happen at segment boundaries (every ``segment_km``, or after
every span), where the field is well defined.  Between segments the field
stays on its device; only a save copies it to the host.  For sharded runs
each rank saves its own block with ``shard=rank``
(:func:`opticomlib_tpu_torch.parallel.fiber.ssfm_sharded`).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["PropagationCheckpointer", "ssfm_propagate_resumable",
           "span_chain_resumable"]


def _config_fingerprint(cfg: dict) -> str:
    return hashlib.sha256(
        json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:16]


def _planar(A: torch.Tensor):
    """The field's (re, im) as host NumPy arrays (the save's one copy off
    the device)."""
    A = A.detach().resolve_conj().cpu().numpy()
    return A.real, A.imag


def _field(re: np.ndarray, im: np.ndarray, device) -> torch.Tensor:
    """complex64 tensor on ``device`` from a checkpoint's (re, im)."""
    return torch.as_tensor((re + 1j * im).astype(np.complex64), device=device)


def _run_device(A) -> torch.device:
    """Where a resumable run computes: the device of the tensor ``A``, or
    (host data) ``gv``'s device."""
    from ..params import current_device

    return A.device if isinstance(A, torch.Tensor) else current_device()


def _shape(A) -> list:
    return list(A.shape) if isinstance(A, torch.Tensor) else list(np.shape(A))


class PropagationCheckpointer:
    """Atomic, versioned (z, field) checkpoints in a directory."""

    def __init__(self, directory: str, config: Optional[dict] = None,
                 shard: Optional[int] = None, keep: int = 2):
        self.dir = directory
        self.fingerprint = _config_fingerprint(config or {})
        self.shard = shard
        self.keep = max(1, keep)
        os.makedirs(directory, exist_ok=True)

    def _name(self, step: int) -> str:
        shard = "" if self.shard is None else f".shard{self.shard}"
        return f"ckpt_{step:08d}{shard}.npz"

    def save(self, step: int, z: float, re: np.ndarray, im: np.ndarray,
             extra: Optional[dict] = None) -> str:
        """Atomically write checkpoint ``step`` and prune old ones."""
        path = os.path.join(self.dir, self._name(step))
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f, z=np.float64(z), re=np.asarray(re),
                    im=np.asarray(im), step=np.int64(step),
                    fingerprint=np.bytes_(self.fingerprint.encode()),
                    extra=np.bytes_(json.dumps(extra or {}).encode()))
            os.replace(tmp, path)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._prune()
        return path

    def _steps(self):
        # exact-name parse: a shard=None checkpointer must NOT match
        # sharded files (``.shard<k>.npz`` also ends with ``.npz``), and
        # the step field may grow past its 08d zero-padding
        shard = "" if self.shard is None else f"\\.shard{self.shard}"
        pat = re.compile(rf"^ckpt_(\d+){shard}\.npz$")
        out = []
        for fn in os.listdir(self.dir):
            m = pat.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(set(out))

    def _prune(self):
        steps = self._steps()
        for s in steps[:-self.keep]:
            try:
                os.unlink(os.path.join(self.dir, self._name(s)))
            except OSError:
                pass

    def load(self, step: int) -> Optional[Tuple[int, float, np.ndarray,
                                                np.ndarray, dict]]:
        """Checkpoint ``step`` as (step, z, re, im, extra), or None when
        the file is missing or corrupt.  A checkpoint written for a
        different physics config is rejected (fingerprint mismatch ->
        ValueError)."""
        path = os.path.join(self.dir, self._name(step))
        try:
            with np.load(path) as d:
                fp = bytes(d["fingerprint"]).decode()
                payload = (int(d["step"]), float(d["z"]), d["re"].copy(),
                           d["im"].copy(),
                           json.loads(bytes(d["extra"]).decode()))
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            # truncated/corrupt archive (np.load raises BadZipFile or
            # ValueError)
            return None
        if fp != self.fingerprint:
            raise ValueError(
                f"checkpoint {path} was written for a different "
                f"configuration (fingerprint {fp} != {self.fingerprint})")
        return payload

    def latest(self) -> Optional[Tuple[int, float, np.ndarray, np.ndarray,
                                       dict]]:
        """Most recent valid checkpoint as (step, z, re, im, extra), or
        None.  Falls back past corrupt files to the previous step."""
        for step in reversed(self._steps()):
            payload = self.load(step)
            if payload is not None:
                return payload
        return None


def ssfm_propagate_resumable(
    A,
    w_rad_s: np.ndarray,
    length: float,
    ckpt_dir: str,
    segment_km: float,
    alpha: float = 0.0,
    beta_2: float = 0.0,
    beta_3: float = 0.0,
    gamma: float = 0.0,
    h: Optional[float] = None,
    phi_max: float = 0.01,
) -> torch.Tensor:
    """Fixed/adaptive-step SSFM over ``length`` km, checkpointing the field
    every ``segment_km``.  On restart with the same ``ckpt_dir`` and
    physics config, resumes from the latest checkpoint instead of z=0.

    ``A``: a complex tensor (the run stays on its device) or host data
    (placed on ``gv``'s device: the card unless ``gv(device='cpu')``).
    Returns the output field as a complex64 tensor on that device.
    """
    from ..ops import ssfm as _ssfm
    dev = _run_device(A)

    # the frequency grid is part of the physics: resuming under a different
    # fs (same n) would mix dispersion applied on two different w grids
    w_arr = np.asarray(w_rad_s, dtype=np.float64)
    w_fp = hashlib.sha256(w_arr.tobytes()).hexdigest()[:16]
    cfg = dict(length=length, alpha=alpha, beta_2=beta_2, beta_3=beta_3,
               gamma=gamma, h=h, phi_max=phi_max, segment_km=segment_km,
               n=int(_shape(A)[-1]), w_grid=w_fp)
    ck = PropagationCheckpointer(ckpt_dir, config=cfg)

    state = ck.latest()
    if state is not None:
        step, z, re, im, _ = state
        A = _field(re, im, dev)
    else:
        step, z = 0, 0.0
        A = torch.as_tensor(A, device=dev).to(torch.complex64)

    while z < length - 1e-9:
        seg = min(segment_km, length - z)
        A, _ = _ssfm.ssfm_propagate(
            A, w_rad_s, length=seg, alpha=alpha, beta_2=beta_2,
            beta_3=beta_3, gamma=gamma, phi_max=phi_max, h=h)
        z += seg
        step += 1
        ck.save(step, z, *_planar(A))
    return A


def span_chain_resumable(A, apply_span, n_spans: int, ckpt_dir: str,
                         config: Optional[dict] = None) -> torch.Tensor:
    """Run ``A -> apply_span(A, 0) -> ... -> apply_span(., n_spans-1)``
    with a checkpoint after every span; resume from the latest valid
    checkpoint on rerun.

    The long-haul span loop of a link (``RepeatSpec`` / per-span FIBER+EDFA
    chains, BASELINE config 4) checkpoints at span boundaries: each
    ``apply_span(field, span_idx)`` takes and returns a complex64 tensor on
    the run's device (a whole span: split-step scan + gain + keyed ASE),
    and only the save copies the field to the host.  Noise keyed by the
    span index (a generator seeded from ``(seed, span_idx)``) makes the
    resumed run draw exactly the ASE of the uninterrupted one, so
    kill-and-resume is bit-exact.

    ``A``: a complex tensor or host data (placed as for
    :func:`ssfm_propagate_resumable`); returns the final field as a
    complex64 tensor on that device.
    """
    dev = _run_device(A)

    cfg = dict(config or {})
    cfg.setdefault("kind", "span_chain")
    cfg["n_spans"] = int(n_spans)
    cfg["shape"] = _shape(A)
    ck = PropagationCheckpointer(ckpt_dir, config=cfg)

    state = ck.latest()
    if state is not None:
        span0, _, re, im, _ = state
        A = _field(re, im, dev)
    else:
        span0 = 0
        A = torch.as_tensor(A, device=dev).to(torch.complex64)

    for s in range(span0, int(n_spans)):
        A = apply_span(A, s).to(torch.complex64)
        ck.save(s + 1, float(s + 1), *_planar(A))
    return A
