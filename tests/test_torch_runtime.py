"""The port's checkpoint/resume (opticomlib_tpu_torch.runtime) against the
JAX package's (opticomlib_tpu.runtime): the cases of tests/test_runtime.py
on both, the files of either loading in the other, and a run begun by one
package's ``ssfm_propagate_resumable`` resumed by the other's.

Tolerances: the resumable run against the straight run at the JAX test's
``atol=1e-5``; the port against the JAX package on the same input at 1e-4 of
the peak (the two split-step solvers, as tests/test_torch_ssfm.py holds
them); kill-and-resume within one package bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from opticomlib_tpu import runtime as jruntime
from opticomlib_tpu.ops import ssfm as jssfm
from opticomlib_tpu.runtime import checkpoint as jckpt
from opticomlib_tpu_torch import gv, runtime as truntime
from opticomlib_tpu_torch.ops import noise as tnoise, ssfm as tssfm
from opticomlib_tpu_torch.runtime import checkpoint as tckpt

torch.set_num_threads(2)

CKPT = {"jax": jckpt.PropagationCheckpointer,
        "torch": tckpt.PropagationCheckpointer}
KW = dict(alpha=0.2, beta_2=-20, gamma=1.3, h=0.5)


def _wgrid(n, fs):
    return 2 * np.pi * np.fft.fftfreq(n) * fs


def _input(n=2048):
    from scipy.ndimage import gaussian_filter1d
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, n // 16).astype(float)
    return gaussian_filter1d(np.repeat(bits, 16), 4).astype(np.complex64) * 0.2


def _dying_save(cls, after):
    """Patch ``cls.save`` to raise once ``after`` saves are on disk; returns
    the undo."""
    orig, calls = cls.save, {"n": 0}

    def dying(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls["n"] += 1
        if calls["n"] == after:
            raise RuntimeError("boom")
        return out

    cls.save = dying
    return lambda: setattr(cls, "save", orig)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_checkpointer_roundtrip(tmp_path, writer, reader):
    """A file written by either package loads in either."""
    re = np.arange(16, dtype=np.float32)
    CKPT[writer](str(tmp_path), config={"a": 1}).save(
        1, 10.0, re, -re, extra={"note": "seg1"})
    step, z, re2, im2, extra = CKPT[reader](str(tmp_path),
                                            config={"a": 1}).latest()
    assert step == 1 and z == 10.0 and extra["note"] == "seg1"
    np.testing.assert_array_equal(re2, re)
    np.testing.assert_array_equal(im2, -re)


def test_checkpointer_prunes_and_keeps_latest(tmp_path):
    ck = tckpt.PropagationCheckpointer(str(tmp_path), config={}, keep=2)
    for s in range(1, 5):
        ck.save(s, float(s), np.zeros(4, np.float32), np.zeros(4, np.float32))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 2
    assert ck.latest()[0] == 4


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpointer_rejects_config_mismatch(tmp_path, writer, reader):
    ck = CKPT[writer](str(tmp_path), config={"gamma": 1.3})
    ck.save(1, 1.0, np.zeros(4, np.float32), np.zeros(4, np.float32))
    assert CKPT[reader](str(tmp_path),
                        config={"gamma": 1.3}).latest()[0] == 1
    with pytest.raises(ValueError, match="different"):
        CKPT[reader](str(tmp_path), config={"gamma": 2.0}).latest()


def test_config_fingerprint_equals_jax():
    cfg = dict(length=4.0, alpha=0.2, beta_2=-20, beta_3=0.0, gamma=1.3,
               h=None, phi_max=0.01, segment_km=1.0, n=2048, w_grid="ab12")
    assert tckpt._config_fingerprint(cfg) == jckpt._config_fingerprint(cfg)


def test_checkpointer_survives_corrupt_latest(tmp_path):
    ck = tckpt.PropagationCheckpointer(str(tmp_path), config={})
    ck.save(1, 1.0, np.ones(4, np.float32), np.zeros(4, np.float32))
    ck.save(2, 2.0, 2 * np.ones(4, np.float32), np.zeros(4, np.float32))
    # simulate a crash that truncated the newest file
    with open(os.path.join(str(tmp_path), "ckpt_00000002.npz"), "wb") as f:
        f.write(b"garbage")
    step, z, re, im, _ = ck.latest()
    assert step == 1 and z == 1.0


def test_checkpointer_shard_isolation(tmp_path):
    """A shard=None checkpointer neither sees nor prunes sharded files in
    the same directory, and the other way round."""
    d, cfg = str(tmp_path), {"k": 1}
    sh = tckpt.PropagationCheckpointer(d, config=cfg, shard=0)
    sh.save(49, 1.0, np.zeros(4), np.zeros(4))
    sh.save(50, 2.0, np.zeros(4), np.zeros(4))
    un = tckpt.PropagationCheckpointer(d, config=cfg)
    assert un._steps() == []                    # sharded files invisible
    un.save(1, 0.5, np.ones(4), np.zeros(4))
    assert un._steps() == [1]                   # own save survives prune
    st = un.latest()
    assert st is not None and st[0] == 1
    assert sh._steps() == [49, 50]
    # and the JAX checkpointer reads the port's shard files by name
    assert jckpt.PropagationCheckpointer(d, config=cfg,
                                         shard=0).latest()[0] == 50


def test_resumable_matches_straight_run_and_jax(tmp_path):
    A = _input()
    w = _wgrid(A.size, 160e9)
    x = torch.from_numpy(A)
    straight, _ = tssfm.ssfm_propagate(x, w, length=4.0, **KW)

    d1 = str(tmp_path / "run")
    out = truntime.ssfm_propagate_resumable(x, w, length=4.0, ckpt_dir=d1,
                                            segment_km=1.0, **KW)
    assert out.dtype == torch.complex64 and out.device == x.device
    np.testing.assert_allclose(out.numpy(), straight.numpy(), atol=1e-5)

    # simulate a crash after 2 segments: drop the later checkpoints
    for f in sorted(os.listdir(d1)):
        if f > "ckpt_00000002.npz":
            os.unlink(os.path.join(d1, f))
    resumed = truntime.ssfm_propagate_resumable(
        x, w, length=4.0, ckpt_dir=d1, segment_km=1.0, **KW)
    np.testing.assert_allclose(resumed.numpy(), straight.numpy(), atol=1e-5)

    # the JAX package's resumable run on the same input
    out_j = jruntime.ssfm_propagate_resumable(
        A, w, length=4.0, ckpt_dir=str(tmp_path / "jax"), segment_km=1.0,
        **KW)
    assert np.max(np.abs(out.numpy() - out_j)) <= 1e-4 * np.max(np.abs(out_j))


def test_resumable_adaptive_kill_and_resume_bitexact(tmp_path):
    """phi_max-adaptive segments: a run killed after its 2nd save resumes
    bit-equal to the uninterrupted segmented run (both probe h0 from the
    same field at each boundary)."""
    A = torch.from_numpy(_input() * 2)
    w = _wgrid(A.numel(), 160e9)
    kw = dict(length=4.0, segment_km=1.0, alpha=0.2, beta_2=-20, gamma=1.3,
              phi_max=0.02)
    full = truntime.ssfm_propagate_resumable(
        A, w, ckpt_dir=str(tmp_path / "full"), **kw)
    undo = _dying_save(tckpt.PropagationCheckpointer, 2)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            truntime.ssfm_propagate_resumable(
                A, w, ckpt_dir=str(tmp_path / "crash"), **kw)
    finally:
        undo()
    resumed = truntime.ssfm_propagate_resumable(
        A, w, ckpt_dir=str(tmp_path / "crash"), **kw)
    assert torch.equal(resumed, full)


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_resumable_run_crosses_packages(tmp_path, first, second):
    """A run begun by one package's ``ssfm_propagate_resumable`` (killed
    after its 2nd save) is resumed by the other's from the same directory:
    the config fingerprints agree, and the result is the uninterrupted
    run's to the tolerance between the two solvers."""
    A = _input()
    w = _wgrid(A.size, 160e9)
    args = dict(length=4.0, segment_km=1.0, **KW)

    def run(which, d):
        if which == "jax":
            return np.asarray(jruntime.ssfm_propagate_resumable(
                A, w, ckpt_dir=d, **args))
        return truntime.ssfm_propagate_resumable(
            torch.from_numpy(A), w, ckpt_dir=d, **args).numpy()

    want = run(first, str(tmp_path / "whole"))
    d = str(tmp_path / "shared")
    undo = _dying_save(CKPT[first], 2)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            run(first, d)
    finally:
        undo()
    assert sorted(os.listdir(d)) == ["ckpt_00000001.npz",
                                     "ckpt_00000002.npz"]
    got = run(second, d)
    assert sorted(os.listdir(d)) == ["ckpt_00000003.npz",
                                     "ckpt_00000004.npz"]
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def test_span_chain_resumable_bitexact(tmp_path):
    """Kill-and-resume at a span boundary of a per-span chain (split-step
    scan + gain + ASE keyed by the span index) reproduces the uninterrupted
    run bit for bit."""
    n, fs, span_L = 2048, 160e9, 5.0
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    phi_w = torch.from_numpy(tssfm.dispersion_phase(w, -21.0, 0.0))
    hs = tssfm.ssfm_step_schedule(span_L, 0.5)
    gain = float(np.float32(10 ** (0.2 * span_L / 20)))

    def apply_span(A, s):
        A = tssfm.ssfm_scan_inside(A, phi_w, hs, 1.3,
                                   tssfm.alpha_per_km(0.2)) * gain
        gen = torch.Generator().manual_seed(42 * 2**16 + s)
        d = tnoise.gaussian((2, n), 1e-4, gen)
        return A + torch.complex(d[0], d[1])

    rng = np.random.default_rng(1)
    A0 = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n)
                           ).astype(np.complex64) * 0.1)
    cfg = dict(physics="test-span")
    full = truntime.span_chain_resumable(A0, apply_span, 4,
                                         str(tmp_path / "full"), cfg)
    assert full.dtype == torch.complex64

    crash_dir = str(tmp_path / "crash")
    undo = _dying_save(tckpt.PropagationCheckpointer, 2)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            truntime.span_chain_resumable(A0, apply_span, 4, crash_dir, cfg)
    finally:
        undo()
    seen = []
    resumed = truntime.span_chain_resumable(
        A0, lambda A, s: seen.append(s) or apply_span(A, s), 4, crash_dir,
        cfg)
    assert seen == [2, 3]
    assert torch.equal(resumed, full)
    # a chain of another length in the same directory is another run
    with pytest.raises(ValueError, match="different"):
        truntime.span_chain_resumable(A0, apply_span, 5, crash_dir, cfg)


def test_resumable_rejects_different_frequency_grid(tmp_path):
    """Resuming with the same n but a different fs (another w grid) is
    rejected through the config fingerprint; every other field is equal."""
    n = 128
    A = torch.from_numpy((np.random.default_rng(0).standard_normal(n)
                          * 0.1).astype(np.complex64))
    w1, w2 = _wgrid(n, 640e9), _wgrid(n, 320e9)
    d = str(tmp_path)
    truntime.ssfm_propagate_resumable(A, w1, 2.0, d, 1.0, alpha=0.2,
                                      beta_2=-21.0, gamma=1.3, h=0.5)
    with pytest.raises(ValueError, match="different"):
        truntime.ssfm_propagate_resumable(A, w2, 2.0, d, 1.0, alpha=0.2,
                                          beta_2=-21.0, gamma=1.3, h=0.5)


def test_host_input_goes_to_gvs_device(tmp_path, monkeypatch):
    """Host data runs on ``gv``'s device: the card when none is named
    (raising without one), the CPU when asked."""
    A, w = _input(256), _wgrid(256, 160e9)
    gv.default()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        truntime.ssfm_propagate_resumable(A, w, 1.0, str(tmp_path / "a"),
                                          1.0, beta_2=-20, h=0.5)
    gv(device="cpu")
    try:
        out = truntime.ssfm_propagate_resumable(
            A, w, 1.0, str(tmp_path / "a"), 1.0, beta_2=-20, h=0.5)
        assert out.device.type == "cpu" and out.shape == (256,)
        out = truntime.span_chain_resumable(A, lambda x, s: x * 0.5, 2,
                                            str(tmp_path / "b"))
    finally:
        gv.default()
    np.testing.assert_allclose(out.numpy(), A * 0.25)


def test_public_names():
    """The JAX module's names, less the XLA compilation cache and the
    small-op backend routing, which an eager program has no use for."""
    not_ported = {"enable_cache", "cache_dir", "set_small_op_threshold",
                  "small_op_threshold"}
    assert set(truntime.__all__) == set(jruntime.__all__) - not_ported
    assert set(tckpt.__all__) == set(jckpt.__all__)
