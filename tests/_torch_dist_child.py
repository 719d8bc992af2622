"""One rank of a ``torch.distributed`` CPU run (gloo) of the port's sharded
fiber, for tests/test_torch_parallel.py.  Not a pytest module; imports no
JAX.

    python _torch_dist_child.py <rank> <world> <rendezvous_file> <out_dir> <suite> [<first item>]

Suites:

* ``w4``     a (1, 4) mesh: every case of :data:`FIELD_CASES` marked
  ``"w4"`` through ``ssfm_sharded`` (rank 0 saves the gathered field as
  ``<case>.npy``), and the in-process checks of :data:`CHECKS_W4`;
* ``w2x2``   a (2, 2) mesh: the 'wdm' cases;
* ``crash``  world size 2: the segmented, checkpointed run dies mid-run at a
  *divergent* point (rank 0 right before its step-2 save, rank 1 right
  after), exit code 17;
* ``resume`` world size 2: resumes from that directory (the ranks must
  agree on step 1), finishes, runs an uninterrupted reference in a fresh
  directory and holds its own block to it bit for bit;
* ``isolate`` world size 2, collectives timing out after 5 s: the items of
  :data:`CHECKS_ISOLATE`, one of which fails on rank 1 between two
  collectives (tests/_torch_dist_items.py then stops the ranks, and the
  items after it run in a fresh launch).

The items of a suite run from ``<first item>`` (an index, default 0) on.
Every rank writes ``results_rank<r>.json``: ``{case: {"ok": bool, "msg":
str, ...}}``.  The input makers and case tables are imported by the test
module, which computes the references (the JAX package, and the port on one
process) from the same seeds.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root (package not pip-installed)

FS = 160e9


def bandlimited(n, seed, amp):
    """Oversampled NRZ-like field (16 samples a bit, gaussian-filtered)."""
    from scipy.ndimage import gaussian_filter1d
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n // 16).astype(float)
    return gaussian_filter1d(np.repeat(bits, 16), 4).astype(np.complex64) * amp


def white(n, seed, amp):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n))
            .astype(np.complex64) * amp)


def make_input(spec):
    kind, *args = spec
    if kind == "band":
        return bandlimited(*args)
    if kind == "white":
        return white(*args)
    if kind == "stack":  # channels
        return np.stack([make_input(s) for s in args])
    raise ValueError(kind)


_NL = dict(alpha=0.2, beta_2=-20, gamma=1.3)
_S = dict(length=8.0, alpha=0.2, beta_2=-21.0, gamma=1.3)
#: name -> (suite, input spec, ssfm_sharded keywords); the cases of
#: tests/test_parallel.py, on 4 time shards (2 x 2 for the channel cases)
FIELD_CASES = {
    "linear": ("w4", ("band", 2**14, 0, 0.2),
               dict(length=10, alpha=0.2, beta_2=-20, h=1.0)),
    "nonlinear": ("w4", ("band", 2**14, 1, 0.3),
                  dict(length=20, h=0.5, **_NL)),
    "overlap": ("w4", ("band", 2**14, 3, 0.2),
                dict(length=10, alpha=0.2, beta_2=-20, h=1.0,
                     method="overlap", halo_safety=16.0)),
    "adaptive_pencil": ("w4", ("band", 2**14, 3, 0.3),
                        dict(length=20, phi_max=0.05, h=None, **_NL)),
    "adaptive_overlap": ("w4", ("band", 2**15, 4, 0.3),
                         dict(length=10, phi_max=0.05, h=None,
                              method="overlap", **_NL)),
    "o4_fixed": ("w4", ("white", 2**13, 5, 0.05),
                 dict(scheme="o4", h=0.5, **_S)),
    "o4_auto": ("w4", ("white", 2**13, 5, 0.05),
                dict(scheme="o4", h=None, tol=1e-5, **_S)),
    "local_error": ("w4", ("white", 2**13, 5, 0.05),
                    dict(scheme="local_error", h=None, tol=1e-5, **_S)),
    "wdm": ("w2x2", ("stack", ("band", 2**13, 20, 0.2),
                     ("band", 2**13, 21, 0.2)),
            dict(length=10, alpha=0.2, beta_2=-20, gamma=1.0, h=1.0)),
    "adaptive_wdm": ("w2x2", ("stack", ("band", 2**13, 5, 0.2),
                              ("band", 2**13, 6, 0.35)),
                     dict(length=10, phi_max=0.05, h=None, **_NL)),
}

#: the staged drop-in: gv(sps=16, R=10e9), an OpticalSignal of this input
FIBER_KW = dict(length=20, alpha=0.2, beta_2=-20.0, gamma=1.3, phi_max=0.05)
FIBER_INPUT = ("band", 2**14, 7, 0.3)
#: the photodiode after it, noiseless
PD_KW = dict(BW=7.5e9, include_noise="none")

CRASH_KW = dict(fs=80e9, length=8.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                h=0.5, segment_km=2.0)
CRASH_INPUT = ("white", 4096, 0, 0.05)


# ---------------------------------------------------------------------------
# in-process checks: each returns a dict of extras or raises
# ---------------------------------------------------------------------------
def _peak_close(a, b, atol):
    scale = np.max(np.abs(b))
    err = float(np.max(np.abs(a - b)) / scale)
    assert err <= atol, f"max abs err / peak {err:.3g} > {atol}"
    return err


def _unsharded(A, kw):
    """The port on one process: what ``ssfm_sharded(A, fs=FS, **kw)`` is
    held to."""
    import torch
    from opticomlib_tpu_torch.ops import ssfm

    kw = {k: v for k, v in kw.items()
          if k not in ("method", "halo_safety", "wdm_axis")}
    scheme = kw.pop("scheme", "reference")
    tol = kw.pop("tol", 1e-5)
    w = 2 * np.pi * np.fft.fftfreq(A.shape[-1]) * FS
    x = torch.from_numpy(A)
    if scheme == "reference":
        out, steps = ssfm.ssfm_propagate(x, w, **kw)
    elif scheme == "o4" and kw.get("h") is not None:
        out, steps = ssfm.ssfm_scan_o4(x, w, **kw)
    else:
        kw.pop("h")
        fn = ssfm.ssfm_o4_auto if scheme == "o4" else ssfm.ssfm_local_error
        out, steps = fn(x, w, tol=tol, **kw)
    return out.numpy(), steps


def check_mesh_construction(ctx):
    from opticomlib_tpu_torch.parallel import make_link_mesh
    mesh1 = make_link_mesh(n_wdm=1)
    assert mesh1.shape == {"wdm": 1, "time": ctx["world"]}
    assert make_link_mesh(n_wdm=1) is mesh1          # built once
    try:
        make_link_mesh(n_wdm=16, n_time=16)
    except ValueError:
        return {}
    raise AssertionError("a 16 x 16 mesh on 4 ranks did not raise")


def check_multihost_idempotent(ctx):
    from opticomlib_tpu_torch.parallel import initialize_multihost
    # a second call returns the world size and starts nothing (the address
    # it is given here could not be reached)
    assert initialize_multihost("nowhere.invalid:1", 99, 98,
                                device="cpu") == ctx["world"]
    return {}


def check_input_validation(ctx):
    from opticomlib_tpu_torch.parallel import ssfm_sharded
    mesh = ctx["mesh"]
    bad = [
        (np.zeros(1002, np.complex64),      # not divisible by 4
         dict(fs=160e9, length=10, beta_2=-20, h=1.0)),
        (np.zeros(2**10, np.complex64),     # halo larger than the block
         dict(fs=10e12, length=10, beta_2=-2000, h=10.0, method="overlap")),
        (np.zeros(4 * 6, np.complex64),     # 6 % 4 != 0
         dict(fs=160e9, length=10, beta_2=-20, h=1.0, method="pencil")),
        (np.zeros(2**13, np.complex64),
         dict(fs=160e9, length=10, beta_2=-20, h=1.0, method="nope")),
    ]
    for A, kw in bad:
        try:
            ssfm_sharded(A, mesh, **kw)
        except ValueError:
            continue
        raise AssertionError(f"no ValueError for {kw}")
    return {}


def check_scheme_validation(ctx):
    import re

    from opticomlib_tpu_torch.parallel import ssfm_sharded
    mesh = ctx["mesh"]
    A0 = np.ones(2**12, np.complex64) * 0.1
    for match, kw in (("scheme", dict(scheme="rk4")),
                      ("pencil", dict(gamma=1.0, scheme="o4",
                                      method="overlap")),
                      ("scheme", dict(gamma=1.0, scheme="nope",
                                      ckpt_dir=os.path.join(
                                          ctx["out"], "never")))):
        try:
            ssfm_sharded(A0, mesh, fs=1e11, length=5, **kw)
        except ValueError as e:
            assert re.search(match, str(e)), (match, str(e))
            continue
        raise AssertionError(f"no ValueError for {kw}")
    return {}


def check_pencil_fft(ctx):
    """pencil_fft against torch.fft.fft in the strided layout, and
    pencil_ifft(pencil_fft(x)) = x, for a 1-D, a (2, n) and a (3, n)
    field."""
    import torch
    from opticomlib_tpu_torch.parallel.dfft import (pencil_fft, pencil_ifft,
                                                    strided_k_local)
    axis = ctx["mesh"].axis("time")
    P, q = axis.size, axis.index
    errs = {}
    for name, x in (("1d", white(2**12, 31, 1.0)),
                    ("2d", np.stack([white(2**10, 32, 1.0),
                                     white(2**10, 33, 0.5)])),
                    ("3ch", np.stack([white(2**10, 34 + c, 0.5 + 0.25 * c)
                                      for c in range(3)]))):
        B = x.shape[-1] // P
        block = torch.from_numpy(x[..., q * B:(q + 1) * B].copy())
        X = pencil_fft(block, axis)
        want = torch.fft.fft(torch.from_numpy(x), dim=-1)[
            ..., torch.from_numpy(strided_k_local(q, P, B))]
        errs[name + "_fft"] = float((X - want).abs().max()
                                    / want.abs().max())
        back = pencil_ifft(X, axis)
        errs[name + "_roundtrip"] = float((back - block).abs().max())
    assert max(errs.values()) <= 2e-6, errs
    return errs


def check_exchange_halos(ctx):
    import torch
    from opticomlib_tpu_torch.parallel.halo import exchange_halos
    axis = ctx["mesh"].axis("time")
    P, q, H = axis.size, axis.index, 5
    x = white(P * 64, 41, 1.0)
    padded = exchange_halos(torch.from_numpy(x[q * 64:(q + 1) * 64].copy()),
                            H, axis)
    want = np.take(x, np.arange(q * 64 - H, (q + 1) * 64 + H), mode="wrap")
    assert np.array_equal(padded.numpy(), want)
    return {}


def _gv16(n_slots):
    from opticomlib_tpu_torch import gv
    gv.default()
    gv(sps=16, R=10e9, N=n_slots, device="cpu")
    return gv


def check_fiber_mesh_drop_in(ctx):
    from opticomlib_tpu_torch.devices import FIBER
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv = _gv16(2**10)
    x = OpticalSignal(make_input(FIBER_INPUT))
    single = FIBER(x, **FIBER_KW)
    sharded = FIBER(x, mesh=ctx["mesh"], **FIBER_KW)
    a, b = sharded.to_numpy(), single.to_numpy()
    if ctx["rank"] == 0:
        np.save(os.path.join(ctx["out"], "fiber_mesh_drop_in.npy"), a)
    gv.default()
    assert sharded.n_steps == single.n_steps, (sharded.n_steps,
                                               single.n_steps)
    return {"err": _peak_close(a, b, 5e-4), "n_steps": sharded.n_steps}


def check_fiber_mesh_rejects_return_steps(ctx):
    from opticomlib_tpu_torch.devices import FIBER
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv = _gv16(128)
    x = OpticalSignal(np.ones(2048, complex) * 0.1)
    try:
        FIBER(x, 10, beta_2=-20, gamma=1.0, mesh=ctx["mesh"],
              return_steps=True)
    except ValueError:
        return {}
    finally:
        gv.default()
    raise AssertionError("mesh= with return_steps=True did not raise")


def check_fiber_mesh_stays_sharded(ctx):
    """Chained FIBER(mesh=) stages keep each block on its rank."""
    from opticomlib_tpu_torch.devices import FIBER
    from opticomlib_tpu_torch.parallel.fiber import ShardedField
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv = _gv16(128)
    A = bandlimited(2048, 21, 0.1)
    cfg = dict(length=5.0, alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5)
    o1 = FIBER(OpticalSignal(A), mesh=ctx["mesh"], **cfg)
    assert isinstance(o1.signal, ShardedField)
    assert o1.signal.local.shape == (2048 // ctx["world"],)
    o2 = FIBER(o1, mesh=ctx["mesh"], **cfg)
    assert isinstance(o2.signal, ShardedField)
    expect = FIBER(FIBER(OpticalSignal(A), **cfg), **cfg).to_numpy()
    got = np.asarray(o2.signal)
    gv.default()
    assert np.max(np.abs(got - expect)) <= 5e-4 * np.max(np.abs(expect))
    return {}


def check_foreign_device_rejected(ctx):
    """A tensor that lies elsewhere than the mesh computes (here: on the
    'meta' device, against this CPU mesh) raises; it is never copied to the
    mesh's device behind the caller's back."""
    import torch
    from opticomlib_tpu_torch.parallel import shard_waveform, ssfm_sharded
    mesh = ctx["mesh"]
    A = torch.empty(2**12, dtype=torch.complex64, device="meta")
    for call in (lambda: shard_waveform(A, mesh),
                 lambda: ssfm_sharded(A, mesh, fs=1e11, length=5,
                                      beta_2=-20, h=1.0),
                 lambda: ssfm_sharded(A, mesh, fs=1e11, length=5, beta_2=-20,
                                      h=1.0, ckpt_dir=os.path.join(
                                          ctx["out"], "never_foreign"))):
        try:
            call()
        except ValueError as e:
            assert "initialize_multihost(device=" in str(e), str(e)
            assert "meta" in str(e) and "cpu" in str(e), str(e)
            continue
        raise AssertionError("a tensor off the mesh's device did not raise")
    # a tensor on the mesh's device and host data are both placed
    x = white(2**12, 7, 0.1)
    a = shard_waveform(torch.from_numpy(x), mesh)
    b = shard_waveform(x, mesh)
    assert torch.equal(a.local, b.local) and a.local.device.type == "cpu"
    return {}


def check_sharded_payload_no_algebra(ctx):
    """The payload of FIBER(mesh=)'s output takes the signal algebra,
    tensor methods and indexing as the whole field, as the JAX signal's
    global array does (each rank gathers it, once); it stays sharded for
    the next FIBER(mesh=); the signal classes know it only by its mark."""
    import sys as _sys

    import torch
    from opticomlib_tpu_torch.devices import FIBER
    from opticomlib_tpu_torch.parallel.fiber import ShardedField
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv = _gv16(128)
    A = bandlimited(2048, 22, 0.1)
    o = FIBER(OpticalSignal(A), 5.0, beta_2=-21.0, gamma=1.3, h=0.5,
              mesh=ctx["mesh"])
    whole = o.to_numpy()
    assert whole.shape == (2048,) and whole.dtype == np.complex64
    assert np.array_equal(np.asarray(o), whole)
    assert o.shape == (2048,) and o.n_pol == 1 and "ShardedField" in repr(o)
    ref = OpticalSignal(torch.from_numpy(whole))
    for op in (lambda s: s * 2.0, lambda s: s + s, lambda s: -s,
               lambda s: s[:16], lambda s: s ** 2, lambda s: s.conj(),
               lambda s: s("w"), lambda s: s * s.conj()):
        got, want = op(o), op(ref)
        assert np.array_equal(got.to_numpy(), want.to_numpy())
    assert torch.equal(o.abs(), ref.abs())
    assert np.array_equal(o.power(), ref.power())
    assert torch.equal(o.signal + 1, ref.signal + 1)
    assert torch.equal(torch.abs(o.signal), ref.signal.abs())
    noisy = OpticalSignal(o.signal, noise=np.zeros(2048))
    assert np.array_equal(noisy.to_numpy(), whole)
    assert isinstance(o.signal, ShardedField)      # still sharded
    gv.default()
    signals = _sys.modules["opticomlib_tpu_torch.signals"]
    assert not hasattr(signals, "ShardedField")
    return {}


def check_fiber_mesh_then_pd(ctx):
    """A staged device after FIBER(mesh=) takes the whole field: the
    photodiode's voltage against the port on one process (rank 0 saves it
    for the test module's JAX reference)."""
    from opticomlib_tpu_torch.devices import FIBER, PD
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv = _gv16(2**10)
    x = OpticalSignal(make_input(FIBER_INPUT))
    fib = FIBER(x, mesh=ctx["mesh"], **FIBER_KW)
    v = PD(fib, **PD_KW).to_numpy()
    if ctx["rank"] == 0:
        np.save(os.path.join(ctx["out"], "fiber_mesh_then_pd.npy"), v)
    want = PD(FIBER(x, **FIBER_KW), **PD_KW).to_numpy()
    p_mesh, p_one = fib.power(), FIBER(x, **FIBER_KW).power()
    gv.default()
    assert abs(p_mesh - p_one) <= 1e-5 * p_one, (p_mesh, p_one)
    return {"err": _peak_close(v, want, 5e-4)}


def check_fiber_mesh_new_methods(ctx):
    from opticomlib_tpu_torch.devices import FIBER
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv = _gv16(512)
    op = OpticalSignal(white(512 * 16, 1, 0.1))
    errs = {}
    for method, kw in (("o4", dict(tol=1e-5)), ("local_error", dict(tol=1e-5)),
                       ("o4", dict(h=1.0))):
        common = dict(length=8, alpha=0.2, beta_2=-21, gamma=1.3,
                      method=method, **kw)
        a = FIBER(op, mesh=ctx["mesh"], **common)
        b = FIBER(op, **common)
        assert a.n_steps == b.n_steps, (method, kw, a.n_steps, b.n_steps)
        a, b = a.to_numpy(), b.to_numpy()
        err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert err < 1e-4, (method, kw, err)
        errs[f"{method}_{'h' if 'h' in kw else 'tol'}"] = err
    gv.default()
    return errs


def check_plan_cache(ctx):
    """A second call with the same (mesh, shape, physics) rebuilds neither
    the phase grid nor the transform's matrices and twiddles."""
    from opticomlib_tpu_torch.parallel import dfft, fiber as pf
    A = bandlimited(2048, 11, 0.1)
    kw = dict(fs=160e9, length=2.0, alpha=0.2, gamma=1.3, h=0.5,
              wdm_axis=None)
    pf._plan_cache.clear()
    dfft._consts.clear()
    out1 = np.asarray(pf.ssfm_sharded(A, ctx["mesh"], beta_2=-21.0, **kw))
    builds = dfft.BUILDS
    assert len(pf._plan_cache) == 1 and len(dfft._consts) == 1
    phi = next(iter(pf._plan_cache.values()))["phi"]
    out2 = np.asarray(pf.ssfm_sharded(A, ctx["mesh"], beta_2=-21.0, **kw))
    assert len(pf._plan_cache) == 1 and dfft.BUILDS == builds
    assert next(iter(pf._plan_cache.values()))["phi"] is phi
    assert np.array_equal(out1, out2)
    # different physics -> a new phase grid, the same transform constants
    pf.ssfm_sharded(A, ctx["mesh"], beta_2=-18.0, **kw)
    assert len(pf._plan_cache) == 2 and dfft.BUILDS == builds
    # the bound holds
    for k in range(pf._PLAN_CACHE_MAX + 3):
        pf._plan_cache_put(("filler", k), {})
    assert len(pf._plan_cache) == pf._PLAN_CACHE_MAX
    pf._plan_cache.clear()
    return {}


def _kill_and_resume(ctx, name, A, cfg, other):
    """Uninterrupted segmented run, a run that dies after its 2nd save,
    the resumed run (bit-equal), and a different physics in the same
    directory (rejected)."""
    from opticomlib_tpu_torch.parallel import ssfm_sharded
    from opticomlib_tpu_torch.runtime.checkpoint import \
        PropagationCheckpointer
    mesh, out = ctx["mesh"], ctx["out"]
    full = ssfm_sharded(A, mesh, segment_km=2.0,
                        ckpt_dir=os.path.join(out, name + "_full"), **cfg)
    crash_dir = os.path.join(out, name + "_crash")
    orig, calls = PropagationCheckpointer.save, {"n": 0}

    def dying(self, *a, **kw):
        r = orig(self, *a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash after segment 2")
        return r

    PropagationCheckpointer.save = dying
    try:
        try:
            ssfm_sharded(A, mesh, segment_km=2.0, ckpt_dir=crash_dir, **cfg)
        except RuntimeError as e:
            assert "simulated crash" in str(e)
        else:
            raise AssertionError("the run did not die")
    finally:
        PropagationCheckpointer.save = orig
    files = sorted(f for f in os.listdir(crash_dir) if f.endswith(
        f".shard{ctx['rank']}.npz"))
    assert files == [f"ckpt_0000000{s}.shard{ctx['rank']}.npz"
                     for s in (1, 2)], files
    resumed = ssfm_sharded(A, mesh, segment_km=2.0, ckpt_dir=crash_dir,
                           **cfg)
    assert np.array_equal(resumed.local.numpy(), full.local.numpy())
    assert np.array_equal(np.asarray(resumed), np.asarray(full))
    try:
        ssfm_sharded(A, mesh, segment_km=2.0, ckpt_dir=crash_dir,
                     **dict(cfg, **other))
    except ValueError as e:
        assert "different" in str(e)
    else:
        raise AssertionError("different physics was not rejected")
    return {}


def check_ckpt_resume_reference(ctx):
    return _kill_and_resume(
        ctx, "ref", bandlimited(2048, 13, 0.15),
        dict(fs=160e9, length=8.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
             h=0.5, wdm_axis=None), dict(gamma=2.0))


def check_ckpt_resume_o4(ctx):
    return _kill_and_resume(
        ctx, "o4", white(2048, 9, 0.1),
        dict(fs=160e9, length=8.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
             h=None, scheme="o4", tol=1e-5, wdm_axis=None),
        dict(scheme="local_error"))


def check_auto_matches_explicit(ctx):
    from opticomlib_tpu_torch.parallel import fiber
    P = ctx["world"]
    n = 2**14
    A0 = white(n, 2, 0.05)
    kw = dict(fs=FS, length=4.0, alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5)
    saved, seen = fiber.AUTO_HALO_FRAC, []
    try:
        for frac in (0.0, 0.25):
            fiber.AUTO_HALO_FRAC = frac
            resolved = fiber.resolve_shard_method(n, P, 0.5, -21.0, 0.0, FS)
            seen.append(resolved)
            a = np.asarray(fiber.ssfm_sharded(A0, ctx["mesh"], method="auto",
                                              **kw))
            b = np.asarray(fiber.ssfm_sharded(A0, ctx["mesh"],
                                              method=resolved, **kw))
            assert np.array_equal(a, b), resolved
    finally:
        fiber.AUTO_HALO_FRAC = saved
    assert seen == ["pencil", "overlap"], seen
    return {}


def check_convert_from_jax(ctx):
    """The JAX package's block payload (written by the test module) becomes
    this rank's block; and back."""
    from opticomlib_tpu_torch import convert
    mesh = ctx["mesh"]
    d = np.load(os.path.join(ctx["out"], "jax_blocks.npz"))
    indices = json.loads(str(d["indices"]))
    field = convert.sharded_from_jax(d["re"], d["im"], indices, mesh,
                                     shape=tuple(d["shape"]))
    whole = convert.sharded_from_jax(d["whole"].real, d["whole"].imag, None,
                                     mesh)
    assert np.array_equal(field.local.numpy(), whole.local.numpy())
    assert np.array_equal(np.asarray(field), d["whole"])
    re, im, extra = convert.sharded_to_jax(field)
    if ctx["rank"] == 0:
        np.savez(os.path.join(ctx["out"], "port_blocks.npz"), re=re, im=im,
                 indices=json.dumps(extra["indices"]))
    return {}


CHECKS_W4 = {
    "mesh_construction": check_mesh_construction,
    "multihost_idempotent": check_multihost_idempotent,
    "input_validation": check_input_validation,
    "scheme_validation": check_scheme_validation,
    "pencil_fft": check_pencil_fft,
    "exchange_halos": check_exchange_halos,
    "fiber_mesh_drop_in": check_fiber_mesh_drop_in,
    "fiber_mesh_rejects_return_steps": check_fiber_mesh_rejects_return_steps,
    "fiber_mesh_stays_sharded": check_fiber_mesh_stays_sharded,
    "fiber_mesh_new_methods": check_fiber_mesh_new_methods,
    "foreign_device_rejected": check_foreign_device_rejected,
    "sharded_payload_no_algebra": check_sharded_payload_no_algebra,
    "fiber_mesh_then_pd": check_fiber_mesh_then_pd,
    "plan_cache": check_plan_cache,
    "ckpt_resume_reference": check_ckpt_resume_reference,
    "ckpt_resume_o4": check_ckpt_resume_o4,
    "auto_matches_explicit": check_auto_matches_explicit,
    "convert_from_jax": check_convert_from_jax,
}


def check_mesh_2x2(ctx):
    mesh = ctx["mesh"]
    assert mesh.shape == {"wdm": 2, "time": 2}
    assert mesh.ranks.tolist() == [[0, 1], [2, 3]]
    assert mesh.coords == {"wdm": ctx["rank"] // 2, "time": ctx["rank"] % 2}
    assert mesh.axis("time").ranks == tuple(mesh.ranks[ctx["rank"] // 2])
    return {}


def check_named_axes(ctx):
    """A mesh named ('ch', 't') has the groups of ('wdm', 'time') and gives
    the same field; 1-D meshes have their one axis."""
    import torch
    from opticomlib_tpu_torch.parallel import ssfm_sharded
    from opticomlib_tpu_torch.parallel.fiber import make_mesh
    mesh = ctx["mesh"]
    named = make_mesh(np.arange(4).reshape(2, 2), ("ch", "t"))
    assert named.shape == {"ch": 2, "t": 2}
    assert named.axis("t").ranks == mesh.axis("time").ranks
    assert named.axis("ch").ranks == mesh.axis("wdm").ranks
    _, spec, kw = FIELD_CASES["adaptive_wdm"]
    A = make_input(spec)
    a = ssfm_sharded(A, mesh, fs=FS, **kw)
    b = ssfm_sharded(A, named, fs=FS, time_axis="t", wdm_axis="ch", **kw)
    assert b.n_steps == a.n_steps and torch.equal(a.local, b.local)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    line = make_mesh(range(4), ("time",))
    assert line.shape == {"time": 4} and line.axis("time").index == ctx["rank"]
    chans = make_mesh(range(4), ("wdm",))
    assert chans.axis("wdm").ranks == (0, 1, 2, 3)
    for call in (lambda: chans.axis("time"),
                 lambda: make_mesh(np.arange(4)[::-1].copy(), ("time",)),
                 lambda: make_mesh(np.arange(4).reshape(2, 2), ("t", "t"))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("no ValueError")
    # a 1-D field on the 1-D 'time' mesh: the (1, 4) mesh's propagation
    x = bandlimited(2**13, 9, 0.2)
    c = ssfm_sharded(x, line, fs=FS, length=5.0, alpha=0.2, beta_2=-20,
                     gamma=1.3, h=0.5)
    ref, _ = _unsharded(x, dict(length=5.0, alpha=0.2, beta_2=-20,
                                gamma=1.3, h=0.5))
    return {"err_line": _peak_close(np.asarray(c), ref, 5e-4)}


def check_mesh_collectives(ctx):
    """all_reduce, all_gather and gather_rows over a named axis and over the
    whole mesh (ranks [[0, 1], [2, 3]])."""
    import torch
    mesh, r = ctx["mesh"], ctx["rank"]
    x = torch.tensor([float(r)])
    row, col = mesh.axis("time").ranks, mesh.axis("wdm").ranks
    assert mesh.all_reduce(x, "sum", "time").item() == sum(row)
    assert mesh.all_reduce(x, "max", "wdm").item() == max(col)
    assert mesh.all_reduce(x, "min", "wdm").item() == min(col)
    assert mesh.all_reduce(x, "mean").item() == 1.5
    assert x.item() == r                                  # not in place
    z = torch.tensor([complex(r, -r)], dtype=torch.complex64)
    assert mesh.all_reduce(z, "sum").item() == complex(6, -6)
    flag = torch.tensor([r != 3])
    assert mesh.all_reduce(flag, "min").item() is False
    assert mesh.all_gather(x, "time").reshape(-1).tolist() == list(row)
    assert mesh.all_gather(z).reshape(-1).tolist() == [
        complex(k, -k) for k in range(4)]
    rows = mesh.gather_rows(torch.tensor([[r, r], [r, -r]]), "wdm")
    assert rows.tolist() == [[k, s * k] for k in col for s in (1, -1)]
    return {}


CHECKS_W2X2 = {"mesh_2x2": check_mesh_2x2, "named_axes": check_named_axes,
               "mesh_collectives": check_mesh_collectives}


def _gather_item(ctx, item):
    """Every rank's (rank, item) through one all-gather: the ranks must
    all be at ``item``."""
    import torch
    import torch.distributed as dist
    mine = torch.tensor([ctx["rank"], item])
    parts = [torch.empty_like(mine) for _ in range(ctx["world"])]
    dist.all_gather(parts, mine)
    got = [p.tolist() for p in parts]
    assert got == [[r, item] for r in range(ctx["world"])], got
    return {}


def check_diverges(ctx):
    """A fault on rank 1 between two collectives: it raises before the
    all-gather that the other ranks make (they wait for it and time out)."""
    if ctx["rank"] == 1:
        raise RuntimeError("simulated fault on rank 1")
    return _gather_item(ctx, 1)


#: the ``isolate`` suite (2 ranks, collectives time out after 5 s): an item
#: that fails on one rank and leaves the group a collective off, and items
#: after it that must still pass
CHECKS_ISOLATE = {"before": lambda ctx: _gather_item(ctx, 0),
                  "diverges": check_diverges,
                  "after": lambda ctx: _gather_item(ctx, 2),
                  "after_again": lambda ctx: _gather_item(ctx, 3)}


def run_field_case(ctx, name):
    from opticomlib_tpu_torch.parallel import ssfm_sharded
    _, spec, kw = FIELD_CASES[name]
    A = make_input(spec)
    out = ssfm_sharded(A, ctx["mesh"], fs=FS, **kw)
    full = out.gather()
    if ctx["rank"] == 0:
        np.save(os.path.join(ctx["out"], name + ".npy"), full)
    # against the port on one process, at the JAX tests' tolerances
    ref, steps = _unsharded(A, kw)
    atol = (5e-3 if kw.get("method") == "overlap" else
            2e-4 if name == "linear" else 5e-4)
    extras = {"n_steps": out.n_steps, "n_steps_unsharded": int(steps)}
    if "scheme" in kw:
        err = float(np.linalg.norm(full - ref) / np.linalg.norm(ref))
        assert err < 1e-4, f"rel L2 {err:.3g} >= 1e-4"
        extras["err"] = err
    else:
        extras["err"] = _peak_close(full, ref, atol)
    if kw.get("method") != "overlap":
        assert out.n_steps == steps, (out.n_steps, steps)
    else:
        # the block is its own allocation, not a view into the padded
        # buffer it was cut from
        assert out.local.data_ptr() % 16 == 0
        assert (out.local.untyped_storage().nbytes()
                == 8 * out.local.numel()), "the padded buffer is kept alive"
    return extras


def crash_or_resume(rank, mesh, out_dir, mode):
    from opticomlib_tpu_torch.parallel import ssfm_sharded
    from opticomlib_tpu_torch.runtime import checkpoint as ckpt_mod
    ckpt = os.path.join(out_dir, "ck")
    if mode == "crash":
        orig_save = ckpt_mod.PropagationCheckpointer.save

        def save(self, step, z, re, im, extra=None):
            if rank == 0 and step == 2:
                os._exit(17)            # dies BEFORE its step-2 save
            r = orig_save(self, step, z, re, im, extra=extra)
            if rank == 1 and step == 2:
                os._exit(17)            # dies right AFTER saving step 2
            return r

        ckpt_mod.PropagationCheckpointer.save = save
    A0 = make_input(CRASH_INPUT)
    A = ssfm_sharded(A0, mesh, ckpt_dir=ckpt, **CRASH_KW)
    assert np.isfinite(A.local.numpy()).all()
    if mode == "resume":
        ref = ssfm_sharded(A0, mesh, ckpt_dir=os.path.join(out_dir, "ref"),
                           **CRASH_KW)
        assert np.array_equal(A.local.numpy(), ref.local.numpy()), (
            "the resumed run is not bit-identical to the uninterrupted run")
        print(f"[child {rank}] OK bitexact", flush=True)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rendezvous, out_dir, suite = sys.argv[3], sys.argv[4], sys.argv[5]
    start = int(sys.argv[6]) if len(sys.argv) > 6 else 0

    import torch
    torch.set_num_threads(1)
    from _torch_dist_items import run_items
    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_link_mesh)

    # a hung collective fails after a minute instead of waiting
    n = initialize_multihost(f"file://{rendezvous}", world, rank,
                             device="cpu",
                             timeout_s=5 if suite == "isolate" else 60)
    assert n == world

    if suite == "isolate":
        ctx = dict(rank=rank, world=world)
        run_items([(name, lambda fn=fn: fn(ctx)) for name, fn in
                   CHECKS_ISOLATE.items()], rank, world, out_dir, start)
        return
    if suite in ("crash", "resume"):
        crash_or_resume(rank, make_link_mesh(n_wdm=1, n_time=world), out_dir,
                        suite)
        return

    mesh = (make_link_mesh(n_wdm=2, n_time=2) if suite == "w2x2"
            else make_link_mesh(n_wdm=1, n_time=world))
    ctx = dict(rank=rank, world=world, mesh=mesh, out=out_dir)
    todo = [(name, lambda name=name: run_field_case(ctx, name))
            for name, case in FIELD_CASES.items() if case[0] == suite]
    todo += [(name, lambda fn=fn: fn(ctx)) for name, fn in
             (CHECKS_W4 if suite == "w4" else CHECKS_W2X2).items()]
    run_items(todo, rank, world, out_dir, start)


if __name__ == "__main__":
    main()
