"""One rank of a ``torch.distributed`` CPU run (gloo) of the port's sharded
fused link, for tests/test_torch_link_sharded.py.  Not a pytest module;
imports no JAX.

    python _torch_link_sharded_child.py <rank> <world> <rendezvous_file> <out_dir> <suite>

Suites (4 ranks each):

* ``t4``    a 1-D mesh of ranks named ('time',): every stage case of
  :data:`STAGE_CASES` through ``build_link(mesh=)`` (rank 0 saves the
  gathered voltage as ``stage_<case>.npy`` for the JAX reference), and the
  checks of :data:`CHECKS_T4`;
* ``w2x2``  a ('wdm', 'time') mesh of 2 x 2 ranks: the checks of
  :data:`CHECKS_W2X2`.

Every rank writes ``results_rank<r>.json``: ``{case: {"ok": bool, "msg":
str, ...}}``; a case passes when it is ok on every rank.  The spec tables
and makers are imported by the test module, which builds the JAX package's
twins of the same links from them.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root (package not pip-installed)

SPS, R = 16, 10e9
N_BITS = 512
BITS = np.random.default_rng(0).integers(0, 2, N_BITS).astype(np.float32)

_FIB = dict(length=50, alpha=0.2, beta_2=-21.0, gamma=1.3)
#: name -> stages, each (kind, keywords); the cases of
#: tests/test_link_sharded.py and test_link_stages.py's sharded o4
STAGE_CASES = {
    "b2b": (),
    "fiber_fixed": (("fiber", dict(_FIB, h=1.0)),),
    "fiber_adaptive": (("fiber", _FIB),),
    "dm": (("fiber", dict(length=40, beta_2=-21.0)),
           ("dm", dict(D=21.0 * 40))),
    "bpf": (("bpf", dict(BW=0.5 * R * SPS)),),
    "edfa_bw": (("edfa", dict(G=3.0, BW=0.6 * R * SPS)),),
    "repeat": (("repeat", (3, (("fiber", dict(length=20, alpha=0.2,
                                              beta_2=-21.0, gamma=1.3,
                                              h=1.0)),
                                ("edfa", dict(G=4.0))))),),
    "dbp": (("fiber", dict(_FIB, h=1.0)), ("edfa", dict(G=10.0)),
            ("dbp", dict(_FIB, h=1.0, undo_gain_dB=10.0))),
    "o4_auto": (("fiber", dict(_FIB, method="o4", tol=1e-5)),),
    "local_error": (("fiber", dict(_FIB, method="local_error", tol=1e-5)),),
    "o4_fixed": (("fiber", dict(_FIB, h=2.5, method="o4")),),
}

#: per-channel adaptive stepping: 8 channels of their own bits
PER_CHANNEL_BITS = np.random.default_rng(3).integers(
    0, 2, (8, N_BITS)).astype(np.float32)


#: the noisy link of the dsp / dsp_wdm cases
NOISY = (("fiber", _FIB), ("edfa", dict(G=10, NF=5)))
#: every noise source at once, for the injected-noise case
ALL_NOISE = dict(lw=1e6, rin=-150.0, include_thermal=True,
                 include_shot=True)


def make_stages(L, stages):
    """The stage specs of the link module ``L`` (the port's or the JAX
    package's) for a table entry."""
    kinds = {"fiber": L.FiberSpec, "dbp": L.DBPSpec, "edfa": L.EDFASpec,
             "dm": L.DMSpec, "bpf": L.BPFSpec}
    out = []
    for kind, kw in stages:
        if kind == "repeat":
            n, sub = kw
            out.append(L.RepeatSpec(n, tuple(make_stages(L, sub))))
        else:
            out.append(kinds[kind](**kw))
    return tuple(out)


def make_spec(L, stages=(), **kw):
    """The JAX test's link (gaussian pulses, MZM, noiseless photodiode
    unless ``kw`` says otherwise) in the link module ``L``."""
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                pd_BW=0.75 * R, include_thermal=False, include_shot=False)
    base.update(kw)
    return L.LinkSpec(stages=make_stages(L, stages), **base)


def params_of(P):
    return P.SimParams.create(sps=SPS, R=R, _warn=False)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _peak_close(a, b, atol):
    scale = np.max(np.abs(b))
    err = float(np.max(np.abs(a - b)) / scale)
    assert err <= atol, f"max abs err / peak {err:.3g} > {atol}"
    return err


def _port():
    from opticomlib_tpu_torch import link, params
    return link, params_of(params)


def _unsharded(spec, n_bits, **kw):
    link, params = _port()
    return link.build_link(spec, n_bits, params, device="cpu", **kw)


def _raises(exc, match, call):
    try:
        call()
    except exc as e:
        assert match in str(e), (match, str(e))
        return
    raise AssertionError(f"no {exc.__name__} ({match})")


# ---------------------------------------------------------------------------
# t4: a 1-D 'time' mesh of 4 ranks
# ---------------------------------------------------------------------------
def run_stage_case(ctx, name):
    """Noiseless sharded == unsharded (2e-5 of the peak), equal steps."""
    import torch
    link, params = _port()
    spec = make_spec(link, STAGE_CASES[name])
    ret = name == "o4_fixed"
    pr1 = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"],
                          return_field=ret)
    out = pr1.jitted(BITS, [0])
    v1 = np.asarray(out[0])[0]
    if ctx["rank"] == 0:
        np.save(os.path.join(ctx["out"], f"stage_{name}.npy"), v1)
    o0 = _unsharded(spec, N_BITS).jitted(torch.from_numpy(BITS), 0)
    steps = [int(s[0]) for s in out[2]]
    assert steps == list(o0[2]), (steps, o0[2])
    return {"err": _peak_close(v1, o0[0].numpy(), 2e-5), "n_steps": steps}


def check_dsp_reproducible_and_consistent(ctx):
    link, params = _port()
    spec = make_spec(link, NOISY, include_thermal=True, include_shot=True)
    pr = link.build_link(spec, 1024, params, mesh=ctx["mesh"])
    r1, r2, r3 = pr.dsp(seed=1), pr.dsp(seed=1), pr.dsp(seed=2)
    assert r1.ber == r2.ber and r1.threshold == r2.threshold
    assert (r1.threshold, r1.eye.mu1) != (r3.threshold, r3.eye.mu1)
    assert r1.ber == 0.0
    r0 = _unsharded(spec, 1024).dsp(seed=1)
    assert abs(r1.eye.mu1 - r0.eye.mu1) < 0.2 * r0.eye.mu1
    assert abs(r1.threshold - r0.threshold) < 0.2 * abs(r0.threshold)
    return {}


def check_dsp_noiseless_matches_unsharded(ctx):
    link, params = _port()
    spec = make_spec(link, (("fiber", dict(_FIB, h=1.0)),))
    r0 = _unsharded(spec, 1024).dsp(seed=3)
    r1 = link.build_link(spec, 1024, params, mesh=ctx["mesh"]).dsp(seed=3)
    assert r1.ber == r0.ber
    np.testing.assert_allclose(r1.threshold, r0.threshold, atol=1e-5)
    np.testing.assert_allclose(r1.eye.mu1, r0.eye.mu1, rtol=1e-4)
    assert r1.n_steps == r0.n_steps
    if ctx["rank"] == 0:
        with open(os.path.join(ctx["out"], "dsp_noiseless.json"), "w") as f:
            json.dump(dict(ber=r1.ber, threshold=r1.threshold,
                           mu1=r1.eye.mu1), f)
    return {}


def check_injected_noise_equals_unsharded(ctx):
    """Every noise source on the same global draws: the sharded chain is
    the unsharded one to float32 round-off."""
    import torch
    link, params = _port()
    spec = make_spec(link, NOISY, **ALL_NOISE)
    n = N_BITS * SPS
    rng = np.random.default_rng(5)
    noise = {k: rng.standard_normal(n).astype(np.float32)
             for k in ("phase", "rin", "thermal", "shot")}
    noise["ase"] = [rng.standard_normal((4, n)).astype(np.float32)]
    pr1 = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"])
    out = pr1.jitted(BITS, [4], noise=[noise])
    o0 = _unsharded(spec, N_BITS).jitted(torch.from_numpy(BITS), 4,
                                         noise=noise)
    assert [int(s[0]) for s in out[2]] == list(o0[2])
    return {"err": _peak_close(np.asarray(out[0])[0], o0[0].numpy(), 2e-5)}


def check_noise_keyed_by_seed(ctx):
    """Without injection: one seed, one waveform; another seed, another."""
    link, params = _port()
    spec = make_spec(link, NOISY, **ALL_NOISE)
    pr = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"])
    a, b, c = (np.asarray(pr.jitted(BITS, [s])[0]) for s in (7, 7, 8))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    return {}


def check_wiener_phase_has_no_block_seams(ctx):
    link, params = _port()
    lw = 1e6
    pr = link.build_link(make_spec(link, (), lw=lw, P0=0.0), N_BITS, params,
                         mesh=ctx["mesh"], return_field=True)
    f = np.asarray(pr.jitted(np.ones(N_BITS, np.float32), [7])[3])[0]
    d = np.abs(np.diff(np.unwrap(np.angle(f))))
    sigma = np.sqrt(2 * np.pi * lw / params.fs)
    assert d.max() < 8 * sigma, (d.max(), sigma)
    return {"max_step_sigma": float(d.max() / sigma)}


def check_validation(ctx):
    link, params = _port()
    mesh = ctx["mesh"]
    _raises(ValueError, "divisible",
            lambda: link.build_link(make_spec(link), 513, params, mesh=mesh))
    pr = link.build_link(make_spec(link), N_BITS, params, mesh=mesh)
    _raises(ValueError, "shape", lambda: pr.dsp_wdm(4, bits=np.zeros((4, 17))))
    _raises(ValueError, "not both", lambda: link.build_link(
        make_spec(link), N_BITS, params, mesh=mesh, span_mesh=mesh))
    _raises(ValueError, "no axis 'span'",
            lambda: link.build_link(make_spec(link), N_BITS, params,
                                    span_mesh=mesh))
    _raises(ValueError, "no axis 'time'", lambda: link.build_link(
        make_spec(link), N_BITS, params, mesh=ctx["wdm_mesh"]))
    return {}


def check_run_gathers(ctx):
    link, params = _port()
    pr = link.build_link(make_spec(link, (("fiber", dict(_FIB, h=1.0)),)),
                         N_BITS, params, mesh=ctx["mesh"])
    r = pr.run(seed=0)
    assert r.v.shape == (N_BITS * SPS,) and r.slots.shape == (N_BITS,)
    assert np.isfinite(r.v).all() and r.rin_ok is True
    return {}


def check_return_field_two_pol(ctx):
    link, params = _port()
    spec = make_spec(link, (("fiber", dict(length=10, alpha=0.2,
                                           beta_2=-21.0, gamma=1.3, h=1.0)),
                            ("edfa", dict(G=2.0, NF=5.0))))
    pr = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"],
                         return_field=True)
    f = np.asarray(pr.jitted(BITS, [0])[3])
    assert f.shape == (1, 2, N_BITS * SPS) and np.isfinite(f).all()
    return {}


def check_longhaul_repeat_dbp_roundtrip(ctx):
    link, params = _port()
    L, G = 20.0, 4.0
    span = dict(length=L, alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5)
    fwd = ("repeat", (4, (("fiber", span), ("edfa", dict(G=G)))))
    bwd = ("repeat", (4, (("dbp", dict(span, undo_gain_dB=G)),)))

    def field(stages):
        pr = link.build_link(make_spec(link, stages), N_BITS, params,
                             mesh=ctx["mesh"], return_field=True)
        return np.asarray(pr.jitted(BITS, [0])[3])[0]

    f_rt, f_b2b = field((fwd, bwd)), field(())
    err = float(np.max(np.abs(f_rt - f_b2b)) / np.max(np.abs(f_b2b)))
    assert err < 5e-3, err
    return {"err": err}


def check_df_matches_unsharded(ctx):
    import torch
    link, params = _port()
    spec = make_spec(link, (), df=1e9)
    v0 = _unsharded(spec, N_BITS).jitted(torch.from_numpy(BITS), 0)[0]
    v1 = np.asarray(link.build_link(spec, N_BITS, params, mesh=ctx["mesh"])
                    .jitted(BITS, [0])[0])[0]
    return {"err": _peak_close(v1, v0.numpy(), 2e-5)}


def check_rin_too_high_raises(ctx):
    link, params = _port()
    _raises(ValueError, "RIN", lambda: link.build_link(
        make_spec(link, (), rin=-80), N_BITS, params, mesh=ctx["mesh"]))
    return {}


def check_adc_matches_unsharded(ctx):
    """The ADC's range from histograms summed over the ranks, against the
    unsharded exact-sort range: within 1.5 LSB."""
    import torch
    link, params = _port()
    bits_n = 6
    spec = make_spec(link, (("fiber", dict(_FIB, h=1.0)),), adc_bits=bits_n)
    v0 = _unsharded(spec, N_BITS).jitted(torch.from_numpy(BITS), 0)[0]
    v0 = v0.numpy()
    v1 = np.asarray(link.build_link(spec, N_BITS, params, mesh=ctx["mesh"])
                    .jitted(BITS, [0])[0])[0]
    lsb = (v0.max() - v0.min()) / (2 ** bits_n - 1)
    assert np.max(np.abs(v1 - v0)) <= 1.5 * lsb
    assert np.unique(np.round(v1, 9)).size <= 2 ** bits_n + 1
    return {"max_lsb": float(np.max(np.abs(v1 - v0)) / lsb)}


def check_chain_spans(ctx):
    """The link chain's spans on each rank: ``tx``, a ``fiber`` span a
    fiber or DBP stage (with the steps the call returns), a ``stage`` span
    every other stage and ``rx.pd``, in the order they run, no span left
    open; the same bits with recording off."""
    from opticomlib_tpu_torch.utils import profiling
    link, params = _port()
    spec = make_spec(link, (("fiber", _FIB), ("edfa", dict(G=10, NF=5)),
                            ("dbp", dict(_FIB, h=1.0, undo_gain_dB=10.0))))
    pr = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"])
    profiling.record(True)
    try:
        on = pr.jitted(BITS, [3])
        recs = profiling.drain()
    finally:
        profiling.record(False)
    off = pr.jitted(BITS, [3])
    assert np.array_equal(np.asarray(on[0]), np.asarray(off[0]))
    assert [r["name"] for r in recs] == ["tx", "fiber", "stage", "fiber",
                                         "rx.pd"], recs
    assert all(r["parent"] is None and r["call"] == r["id"] for r in recs)
    fib, edfa, dbp = recs[1:4]
    assert edfa["attrs"] == {"kind": "edfa"}
    assert (fib["attrs"]["kind"], fib["attrs"]["method"]) == ("fiber",
                                                              "reference")
    assert dbp["attrs"] == dict(kind="dbp", method="reference", steps=50,
                                fused=False)
    assert list(fib["attrs"]["steps"]) == list(on[2][0]) and \
        list(on[2][1]) == [50]
    assert all(r["t0_ns"] <= r["t1_ns"] for r in recs)
    return {}


def check_consts_equal_jax(ctx):
    """The JAX ShardedLinkProgram's constants (written by the test module)
    are this rank's buffers bit for bit, and load into the program."""
    import torch
    from opticomlib_tpu_torch.convert import consts_from_jax
    link, params = _port()
    spec = make_spec(link, CONSTS_STAGES, df=1e9)
    pr = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"])
    d = np.load(os.path.join(ctx["out"], "jax_consts.npz"))
    got = consts_from_jax(dict(d), ctx["mesh"])
    bufs = dict(pr.named_buffers())
    assert set(got) == set(bufs), (sorted(got), sorted(bufs))
    for k, v in got.items():
        assert torch.equal(v.to(bufs[k].dtype), bufs[k]), k
    before = np.asarray(pr.jitted(BITS, [0])[0])
    pr.load_consts(got)
    assert np.array_equal(np.asarray(pr.jitted(BITS, [0])[0]), before)
    return {}


#: the stages whose constants the consts case compares: a BPF, an EDFA
#: band-pass of another width, a DM
CONSTS_STAGES = (("bpf", dict(BW=0.5 * R * SPS)),
                 ("edfa", dict(G=3.0, BW=0.6 * R * SPS)),
                 ("dm", dict(D=200.0)))


def check_mesh_sweeps(ctx):
    """LinkProgram.dsp_wdm / dsp_wdm_ppm with mesh= (a 1-D 'wdm' mesh of
    the 4 ranks, 2 channels a rank) equal the plain sweeps."""
    link, params = _port()
    wdm = ctx["wdm_mesh"]
    spec = make_spec(link, (), P0=-18, include_thermal=True)
    prog = _unsharded(spec, N_BITS)
    bits = np.random.default_rng(6).integers(0, 2, (8, N_BITS))
    plain = prog.dsp_wdm(8, bits=bits, seed=3)
    sharded = prog.dsp_wdm(8, bits=bits, seed=3, mesh=wdm)
    np.testing.assert_array_equal(sharded.n_errors, plain.n_errors)
    np.testing.assert_allclose(sharded.threshold, plain.threshold, rtol=1e-6)
    np.testing.assert_allclose(sharded.mu1, plain.mu1, rtol=1e-6)
    assert sharded.n_steps == plain.n_steps
    spec = make_spec(link, (("fiber", dict(length=10, alpha=0.2,
                                           beta_2=-21.0, gamma=1.3,
                                           h=1.0)),), include_thermal=True)
    prog = _unsharded(spec, 64 * 8)
    for decision in ("soft", "hard"):
        sw = prog.dsp_wdm_ppm(8, M=8, decision=decision, seed=0)
        sw_m = prog.dsp_wdm_ppm(8, M=8, decision=decision, seed=0, mesh=wdm)
        np.testing.assert_array_equal(sw_m.n_errors, sw.n_errors)
        if decision == "hard":
            np.testing.assert_allclose(sw_m.threshold, sw.threshold,
                                       rtol=1e-6)
    return {"n_errors": plain.n_errors.tolist()}


def check_wdm_time_mesh_1x4(ctx):
    """The same 4 ranks as a ('wdm', 'time') mesh of 1 x 4 give the 1-D
    'time' mesh's waveforms bit for bit, and sweep 2 channels on one row."""
    from opticomlib_tpu_torch.parallel import make_link_mesh
    link, params = _port()
    spec = make_spec(link, NOISY, include_thermal=True)
    bits = PER_CHANNEL_BITS[:2]
    a = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"]).jitted(
        bits, [1, 2])
    pr = link.build_link(spec, N_BITS, params, mesh=make_link_mesh(1, 4))
    b = pr.jitted(bits, [1, 2])
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert [s.tolist() for s in a[2]] == [s.tolist() for s in b[2]]
    sw = pr.dsp_wdm(2, bits=bits.astype(np.uint8), seed=1)
    assert sw.ber.shape == (2,) and np.isfinite(sw.threshold).all()
    return {}


CHECKS_T4 = {
    "dsp_reproducible_and_consistent": check_dsp_reproducible_and_consistent,
    "dsp_noiseless_matches_unsharded": check_dsp_noiseless_matches_unsharded,
    "injected_noise_equals_unsharded": check_injected_noise_equals_unsharded,
    "noise_keyed_by_seed": check_noise_keyed_by_seed,
    "wiener_phase_has_no_block_seams": check_wiener_phase_has_no_block_seams,
    "validation": check_validation,
    "run_gathers": check_run_gathers,
    "return_field_two_pol": check_return_field_two_pol,
    "longhaul_repeat_dbp_roundtrip": check_longhaul_repeat_dbp_roundtrip,
    "df_matches_unsharded": check_df_matches_unsharded,
    "rin_too_high_raises": check_rin_too_high_raises,
    "adc_matches_unsharded": check_adc_matches_unsharded,
    "chain_spans": check_chain_spans,
    "consts_equal_jax": check_consts_equal_jax,
    "mesh_sweeps": check_mesh_sweeps,
    "wdm_time_mesh_1x4": check_wdm_time_mesh_1x4,
}


# ---------------------------------------------------------------------------
# w2x2: a ('wdm', 'time') mesh of 2 x 2 ranks
# ---------------------------------------------------------------------------
def check_dsp_wdm(ctx):
    link, params = _port()
    spec = make_spec(link, NOISY, include_thermal=True, include_shot=True)
    pr = link.build_link(spec, 1024, params, mesh=ctx["mesh"])
    sw = pr.dsp_wdm(8, seed=0)
    assert sw.ber.shape == (8,) and np.isfinite(sw.threshold).all()
    assert (sw.ber == 0).all()
    sw2 = pr.dsp_wdm(8, seed=0)
    np.testing.assert_array_equal(sw.n_errors, sw2.n_errors)
    np.testing.assert_array_equal(sw.threshold, sw2.threshold)
    b = np.random.default_rng(5).integers(0, 2, 1024).astype(np.uint8)
    same = pr.dsp_wdm(8, bits=np.tile(b, (8, 1)), seed=0)
    assert (same.ber == same.ber[0]).all()
    _raises(ValueError, "dsp_wdm(n_channels=k*2)", lambda: pr.dsp())
    _raises(ValueError, "mesh without", lambda: pr.run())
    _raises(ValueError, "divisible", lambda: pr.dsp_wdm(3))
    return {}


def check_wdm_noiseless_channels_identical(ctx):
    link, params = _port()
    pr = link.build_link(make_spec(link, (("fiber", dict(_FIB, h=1.0)),)),
                         N_BITS, params, mesh=ctx["mesh"])
    v = np.asarray(pr.jitted(np.tile(BITS, (8, 1)), np.zeros(8))[0])
    for c in range(1, 8):
        np.testing.assert_allclose(v[c], v[0], atol=1e-6)
    return {}


def check_dsp_wdm_ppm(ctx):
    link, params = _port()
    spec = make_spec(link, (("fiber", dict(length=10, alpha=0.2,
                                           beta_2=-21.0, gamma=1.3,
                                           h=1.0)),), include_thermal=True)
    M, n_sym = 8, 64
    prog = link.build_link(spec, n_sym * M, params, mesh=ctx["mesh"])
    sw = prog.dsp_wdm_ppm(4, M=M, seed=0)
    assert sw.ber.shape == (4,) and (sw.ber == 0).all()
    np.testing.assert_array_equal(prog.dsp_wdm_ppm(4, M=M, seed=0).n_errors,
                                  sw.n_errors)
    sw0 = _unsharded(spec, n_sym * M).dsp_wdm_ppm(4, M=M, bits=sw.tx, seed=0)
    np.testing.assert_array_equal(sw0.ber, sw.ber)
    assert sw.n_repaired is None and sw0.n_repaired is None
    return {}


def check_wdm_ppm_hard(ctx):
    link, params = _port()
    spec = make_spec(link, (("fiber", dict(length=10, alpha=0.2,
                                           beta_2=-21.0, gamma=1.3,
                                           h=1.0)),))
    M, n_sym = 8, 64
    prog = link.build_link(spec, n_sym * M, params, mesh=ctx["mesh"])
    sw = prog.dsp_wdm_ppm(4, M=M, decision="hard", seed=0)
    assert sw.ber.shape == (4,) and (sw.ber == 0).all()
    assert sw.threshold is not None and np.isfinite(sw.threshold).all()
    sw2 = prog.dsp_wdm_ppm(4, M=M, decision="hard", seed=0)
    np.testing.assert_array_equal(sw.n_errors, sw2.n_errors)
    sw0 = _unsharded(spec, n_sym * M).dsp_wdm_ppm(4, M=M, decision="hard",
                                                  bits=sw.tx, seed=0)
    np.testing.assert_array_equal(sw0.ber, sw.ber)
    np.testing.assert_allclose(sw0.threshold, sw.threshold, rtol=1e-3,
                               atol=1e-6)
    assert sw.n_repaired.shape == (4,) and sw.n_repaired.dtype == np.int64
    np.testing.assert_array_equal(sw0.n_repaired, sw.n_repaired)
    return {}


def check_per_channel_adaptive_stepping(ctx):
    """Every channel of an 8-channel sharded run equals its unsharded
    single-channel twin, with its own step count (rank 0 saves the
    gathered voltages for the JAX reference)."""
    import torch
    link, params = _port()
    spec = make_spec(link, (("fiber", _FIB),))
    out = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"]).jitted(
        PER_CHANNEL_BITS, np.zeros(8))
    v = np.asarray(out[0])
    if ctx["rank"] == 0:
        np.save(os.path.join(ctx["out"], "per_channel.npy"), v)
    pr0 = _unsharded(spec, N_BITS)
    errs, steps = [], out[2][0].tolist()
    for c in range(8):
        o0 = pr0.jitted(torch.from_numpy(PER_CHANNEL_BITS[c]), 0)
        assert steps[c] == o0[2][0], (c, steps[c], o0[2])
        errs.append(_peak_close(v[c], o0[0].numpy(), 2e-5))
    return {"err": max(errs), "n_steps": steps}


def check_named_mesh_link(ctx):
    """The link on a mesh named ('ch', 't') equals the one on
    ('wdm', 'time')."""
    from opticomlib_tpu_torch.parallel.fiber import make_mesh
    link, params = _port()
    named = make_mesh(np.arange(4).reshape(2, 2), ("ch", "t"))
    spec = make_spec(link, NOISY, include_thermal=True)
    a = link.build_link(spec, N_BITS, params, mesh=ctx["mesh"]).jitted(
        PER_CHANNEL_BITS[:4], np.arange(4))
    b = link.build_link(spec, N_BITS, params, mesh=named, time_axis="t",
                        wdm_axis="ch").jitted(PER_CHANNEL_BITS[:4],
                                              np.arange(4))
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert [s.tolist() for s in a[2]] == [s.tolist() for s in b[2]]
    return {}


CHECKS_W2X2 = {
    "dsp_wdm": check_dsp_wdm,
    "wdm_noiseless_channels_identical": check_wdm_noiseless_channels_identical,
    "dsp_wdm_ppm": check_dsp_wdm_ppm,
    "wdm_ppm_hard": check_wdm_ppm_hard,
    "per_channel_adaptive_stepping": check_per_channel_adaptive_stepping,
    "named_mesh_link": check_named_mesh_link,
}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rendezvous, out_dir, suite = sys.argv[3], sys.argv[4], sys.argv[5]
    start = int(sys.argv[6]) if len(sys.argv) > 6 else 0

    import torch
    torch.set_num_threads(1)
    from _torch_dist_items import run_items
    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_link_mesh)
    from opticomlib_tpu_torch.parallel.fiber import make_mesh

    # a hung collective fails after a minute instead of waiting
    n = initialize_multihost(f"file://{rendezvous}", world, rank,
                             device="cpu", timeout_s=60)
    assert n == world
    if suite == "t4":
        mesh = make_mesh(range(world), ("time",))
        todo = [(f"stage_{k}", lambda k=k: run_stage_case(ctx, k))
                for k in STAGE_CASES]
        checks = CHECKS_T4
    else:
        mesh = make_link_mesh(n_wdm=2, n_time=2)
        todo, checks = [], CHECKS_W2X2
    ctx = dict(rank=rank, world=world, mesh=mesh, out=out_dir,
               wdm_mesh=make_mesh(range(world), ("wdm",)))
    todo += [(name, lambda fn=fn: fn(ctx)) for name, fn in checks.items()]
    run_items(todo, rank, world, out_dir, start)


if __name__ == "__main__":
    main()
