"""One rank of a ``torch.distributed`` CPU run (gloo) of the port's span
pipeline and pipelined link, for tests/test_torch_link_pipeline.py.  Not a
pytest module; imports no JAX.

    python _torch_link_pipeline_child.py <rank> <world> <rendezvous_file> <out_dir> <suite>

Suites:

* ``s4``  4 ranks as a ``('span',)`` mesh (``make_span_mesh(4)``): the
  pipeline cases of tests/test_parallel.py and tests/test_link_pipeline.py
  (:data:`CHECKS_S4`, :data:`MATRIX`), and the runs on the JAX package's
  inputs and draws that the test module wrote to ``jax_inputs.npz`` (rank 0
  saves their outputs for the JAX comparison);
* ``s1``  world size 1, ``make_span_mesh(1)``: the single span, the
  sequential run of the keyed-ASE chain (saved, held bit for bit to the
  4-rank run) and the mesh's validation (:data:`CHECKS_S1`).

Every rank writes ``results_rank<r>.json``: ``{case: {"ok": bool, "msg":
str, ...}}``; a case passes when it is ok on every rank.  The tables and
makers are imported by the test module, which builds the JAX package's
twins from them.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root (package not pip-installed)

SPS, R, N_BITS = 8, 10e9, 256
_FIB = dict(length=20, alpha=0.2, beta_2=-21.0, gamma=1.3)

#: config 4's shape at 4 + 4 spans (tests/test_link_pipeline.py CONFIG4)
CONFIG4 = (("repeat", (4, (("fiber", dict(_FIB, h=0.5)),
                           ("edfa", dict(G=4.0))))),
           ("repeat", (4, (("dbp", dict(_FIB, h=0.5, undo_gain_dB=4.0)),))))
#: 8 x (fiber + noisy EDFA)
NOISY8 = (("repeat", (8, (("fiber", dict(_FIB, h=0.5)),
                          ("edfa", dict(G=4.0, NF=5.0))))),)
#: tests/test_link_pipeline.py _PIPE_MATRIX: every stage type pipelined
MATRIX = {
    "fiber_fixed": (("repeat", (8, (("fiber", dict(_FIB, h=0.5)),))),),
    "fiber_adaptive": (("repeat", (8, (("fiber", _FIB),))),),
    "o4_fixed": (("repeat", (8, (("fiber", dict(_FIB, h=0.5,
                                                method="o4")),))),),
    "o4_auto": (("repeat", (8, (("fiber", dict(_FIB, method="o4",
                                               tol=1e-5)),))),),
    "local_error": (("repeat", (8, (("fiber", dict(
        _FIB, method="local_error", tol=1e-5)),))),),
    "dm": (("repeat", (8, (("fiber", dict(length=20, beta_2=-21.0)),
                           ("dm", dict(D=21.0 * 20))))),),
    "bpf": (("repeat", (8, (("bpf", dict(BW=0.5 * R * SPS)),))),),
    "edfa_bw": (("repeat", (8, (("edfa", dict(G=0.5, BW=0.6 * R * SPS)),
                                ))),),
    "fiber_edfa_bw": (("repeat", (8, (("fiber", dict(_FIB, h=0.5)),
                                      ("edfa", dict(G=4.0,
                                                    BW=0.6 * R * SPS))))),),
    "dbp_undo": CONFIG4,
}
#: the keyed-ASE chain run at 4 ranks and at 1 (tests/test_parallel.py
#: test_span_pipeline_stages_schedule_independence_with_ase)
ASE_CHAIN = (("repeat", (8, (("fiber", dict(length=5, alpha=0.2,
                                            beta_2=-21.0, gamma=1.3,
                                            h=0.5)),
                             ("edfa", dict(G=1.0, NF=5.0))))),)
#: the same chain without ASE, for the noiseless JAX comparison
QUIET_CHAIN = (("repeat", (8, (("fiber", dict(length=5, alpha=0.2,
                                              beta_2=-21.0, gamma=1.3,
                                              h=0.5)),
                               ("edfa", dict(G=1.0))))),)
#: the link of the JAX comparison of dsp_wdm: every noise source
JAX_LINK = dict(lw=1e6, rin=-150.0, include_thermal=True, include_shot=True)
CHAIN_B, CHAIN_N, CHAIN_FS = 8, 1024, 160e9


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
    """tests/test_link_pipeline.py's link in the link module ``L``."""
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                pd_BW=0.75 * R, include_thermal=False, include_shot=False)
    base.update(kw)
    return L.LinkSpec(stages=make_stages(L, stages), **base)


def params_of(P):
    return P.SimParams.create(sps=SPS, R=R, _warn=False)


def batch(B, n, seed, amp=0.1):
    """The tests' white complex batch."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)))
            .astype(np.complex64) * amp)


def wgrid(n, fs):
    return 2 * np.pi * np.fft.fftfreq(n) * fs


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


def _raises(exc, match, call):
    try:
        call()
    except exc as e:
        assert match in str(e), (match, str(e))
        return
    raise AssertionError(f"no {exc.__name__} ({match})")


def _sequential_spans(A, S, fs, span_L, keyed=None, **kw):
    """The spans one after another on one process: ``ssfm_propagate`` and
    the transparent gain a span, plus ``keyed(m, d)``'s ``(2, n)`` draws."""
    import torch
    from opticomlib_tpu_torch.ops import ssfm
    w = wgrid(A.shape[-1], fs)
    g = 10.0 ** (kw.get("alpha", 0.0) * span_L / 20.0)
    out = A.copy()
    for d in range(S):
        for m in range(len(out)):
            y = ssfm.ssfm_propagate(torch.from_numpy(out[m]), w, span_L,
                                    **kw)[0].numpy() * np.float32(g)
            if keyed is not None:
                dr = keyed(m, d)
                y = y + (dr[0] + 1j * dr[1])
            out[m] = y
    return out


def _fields(ctx, stages, bits):
    """Launch fields (the back-to-back program) and the fused link's fields
    after ``stages``, one row a channel of ``bits``."""
    import torch
    link, params = _port()
    outs = []
    for st in ((), stages):
        pr = link.build_link(make_spec(link, st), N_BITS, params,
                             device="cpu", return_field=True)
        outs.append(np.stack([pr.jitted(torch.from_numpy(b), 0)[3].numpy()
                              for b in bits]))
    return outs


# ---------------------------------------------------------------------------
# s4: the cases of tests/test_parallel.py
# ---------------------------------------------------------------------------
def check_span_pipeline_matches_sequential(ctx):
    from opticomlib_tpu_torch.parallel import span_pipeline
    A = batch(8, 1024, 3)
    cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
    out = np.asarray(span_pipeline(A, ctx["mesh"], 160e9, 5.0, h=0.5, **cfg))
    expect = _sequential_spans(A, 4, 160e9, 5.0, h=0.5, **cfg)
    return {"err": _peak_close(out, expect, 5e-4)}


def check_span_pipeline_sharded_output(ctx):
    """The batch is sharded over 'span': rank d holds rows [d*B/S,
    (d+1)*B/S) and nothing else, and the rows are the sequential ones."""
    from opticomlib_tpu_torch.parallel import span_pipeline
    from opticomlib_tpu_torch.parallel.fiber import ShardedField
    A = batch(8, 512, 7)
    cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3, h=1.0)
    out = span_pipeline(A, ctx["mesh"], 160e9, 2.0, **cfg)
    assert isinstance(out, ShardedField) and out.shape == (8, 512)
    r = ctx["rank"]
    assert tuple(out.local.shape) == (2, 512)
    assert out.indices == [[2 * r, 2 * r + 2], [0, 512]], out.indices
    expect = _sequential_spans(A, 4, 160e9, 2.0, **cfg)
    _peak_close(out.local.numpy(), expect[2 * r:2 * r + 2], 1e-3)
    return {"err": _peak_close(np.asarray(out), expect, 1e-3)}


def check_span_pipeline_rejects_indivisible_batch(ctx):
    from opticomlib_tpu_torch.parallel import span_pipeline
    _raises(ValueError, "multiple of the span count", lambda: span_pipeline(
        np.zeros((6, 256), np.complex64), ctx["mesh"], 80e9, 1.0, h=0.5))
    return {}


def check_span_pipeline_keyed_ase(ctx):
    """Per-span keyed ASE: the sequential chain with the same keyed draws
    (a function of (microbatch, span) only)."""
    import torch
    from scipy.constants import c as c_light, h as h_planck
    from opticomlib_tpu_torch.parallel import span_pipeline
    from opticomlib_tpu_torch.ops.noise import keyed_generator
    A = batch(8, 512, 3)
    cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
    span_L, NF, seed = 5.0, 5.0, 123
    out = np.asarray(span_pipeline(A, ctx["mesh"], 160e9, span_L, h=0.5,
                                   NF=NF, seed=seed, **cfg))
    G_lin = 10.0 ** (cfg["alpha"] * span_L / 10.0)
    P_ase = 10.0 ** (NF / 10.0) * h_planck * (c_light / 1550e-9) * (
        G_lin - 1.0) * 160e9
    sigma = np.float32(np.sqrt(P_ase / 4.0))

    def keyed(m, d):
        g = keyed_generator("cpu", seed, m, d)
        return torch.randn((2, 512), generator=g).numpy() * sigma

    expect = _sequential_spans(A, 4, 160e9, span_L, keyed=keyed, h=0.5,
                               **cfg)
    return {"err": _peak_close(out, expect, 5e-4)}


def check_span_pipeline_adaptive(ctx):
    from opticomlib_tpu_torch.parallel import span_pipeline
    A = batch(8, 512, 9)
    cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.02)
    out = np.asarray(span_pipeline(A, ctx["mesh"], 160e9, 5.0, h=None,
                                   **cfg))
    expect = _sequential_spans(A, 4, 160e9, 5.0, h=None, **cfg)
    return {"err": _peak_close(out, expect, 5e-4)}


def check_stages_config4_matches_fused_link(ctx):
    """Config 4's shape (4 x (FIBER+EDFA) + 4 x DBP, 8 segments, 2 a rank)
    reproduces the fused LinkProgram's field, and the round trip undoes
    the spans."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.parallel.pipeline import span_pipeline_stages
    _, params = _port()
    bits = np.random.default_rng(7).integers(0, 2, (8, N_BITS)).astype(
        np.float32)
    f_in, f_out = _fields(ctx, CONFIG4, bits)
    out = np.asarray(span_pipeline_stages(
        f_in, ctx["mesh"], params.fs, make_stages(link, CONFIG4)))
    err = _peak_close(out, f_out, 2e-5)
    rt = float(np.max(np.abs(out - f_in)) / np.max(np.abs(f_out)))
    assert rt < 5e-3, rt
    return {"err": err, "round_trip": rt}


def check_stages_dm_and_attenuator(ctx):
    """DMSpec and a noiseless attenuating EDFASpec lower to unit and zero
    length segments; 4 segments over 4 ranks match the fused link."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.parallel.pipeline import span_pipeline_stages
    _, params = _port()
    stages = (("fiber", dict(length=40, alpha=0.2, beta_2=-21.0, gamma=0.0)),
              ("dm", dict(D=21.0 * 40)), ("edfa", dict(G=-3.0)),
              ("fiber", dict(length=10, alpha=0.0, beta_2=-5.0, gamma=1.3,
                             h=0.5)))
    bits = np.random.default_rng(9).integers(0, 2, (4, N_BITS)).astype(
        np.float32)
    f_in, f_out = _fields(ctx, stages, bits)
    out = np.asarray(span_pipeline_stages(
        f_in, ctx["mesh"], params.fs, make_stages(link, stages)))
    return {"err": _peak_close(out, f_out, 2e-5)}


def check_stages_keyed_ase_schedule(ctx):
    """The keyed-ASE chain at this world size: promoted to 2 pol, saved
    for the comparison with the other world size (bit for bit)."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.parallel.pipeline import span_pipeline_stages
    out = span_pipeline_stages(batch(CHAIN_B, CHAIN_N, 5), ctx["mesh"],
                               CHAIN_FS, make_stages(link, ASE_CHAIN), seed=3)
    full = np.asarray(out)
    assert full.shape == (CHAIN_B, 2, CHAIN_N)
    if ctx["rank"] == 0:
        np.save(os.path.join(ctx["out"], f"ase_chain_{ctx['world']}.npy"),
                full)
    return {}


def check_stages_validation(ctx):
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.parallel.pipeline import (pipeline_stages_core,
                                                        span_pipeline_stages)
    mesh = ctx["mesh"]
    st = make_stages(link, (("fiber", dict(_FIB, h=0.5)),) * 3)
    _raises(ValueError, "not a multiple of the span count",
            lambda: pipeline_stages_core(mesh, 80e9, st, n=64, B=4))
    _raises(ValueError, "batch size 6 must be a multiple",
            lambda: pipeline_stages_core(mesh, 80e9, st + st[:1], n=64, B=6))
    _raises(ValueError, "zero pipeline segments",
            lambda: pipeline_stages_core(mesh, 80e9, (), n=64, B=4))
    _raises(ValueError, "(B, n)", lambda: span_pipeline_stages(
        np.zeros((4, 2, 64), np.complex64), mesh, 80e9, st + st[:1]))
    return {}


def run_jax_inputs(ctx):
    """The JAX package's inputs and draws (jax_inputs.npz, written by the
    test module): span_pipeline_stages with ASE on the injected JAX draws
    and without ASE, span_pipeline with ASE, and the pipelined link's
    dsp_wdm(8) on the JAX program's TX constants and draws.  Rank 0 saves
    what the test module compares."""
    import torch
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.convert import consts_from_jax
    from opticomlib_tpu_torch.parallel import span_pipeline
    from opticomlib_tpu_torch.parallel.pipeline import span_pipeline_stages
    d = np.load(os.path.join(ctx["out"], "jax_inputs.npz"))
    mesh, out = ctx["mesh"], {}
    A = d["chain_in"]
    noise = [list(d["chain_ase"][m]) for m in range(CHAIN_B)]
    out["chain_ase"] = np.asarray(span_pipeline_stages(
        A, mesh, CHAIN_FS, make_stages(link, ASE_CHAIN), noise=noise))
    out["chain_quiet"] = np.asarray(span_pipeline_stages(
        A, mesh, CHAIN_FS, make_stages(link, QUIET_CHAIN)))
    out["spans_ase"] = np.asarray(span_pipeline(
        A, mesh, CHAIN_FS, 5.0, alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5,
        NF=5.0, noise=[list(d["spans_ase"][m]) for m in range(CHAIN_B)]))
    _, params = _port()
    pr = link.build_link(make_spec(link, NOISY8, **JAX_LINK), N_BITS, params,
                         span_mesh=mesh)
    consts = {k[len("const_"):]: d[k] for k in d.files
              if k.startswith("const_")}
    pr.load_consts(consts_from_jax(consts))
    names = ("phase", "rin", "thermal", "shot")
    link_noise = [dict({k: d[f"link_{k}"][c] for k in names},
                       ase=list(d["link_ase"][c])) for c in range(8)]
    sw = pr.dsp_wdm(8, bits=d["link_bits"], seed=11, noise=link_noise)
    out["link_n_errors"] = sw.n_errors
    out["link_threshold"] = sw.threshold
    out["link_mu1"] = sw.mu1
    bufs = dict(pr.named_buffers())
    for k, v in consts_from_jax(consts).items():
        assert torch.equal(v.to(bufs["_tx." + k].dtype), bufs["_tx." + k]), k
    if ctx["rank"] == 0:
        np.savez(os.path.join(ctx["out"], "port_outputs.npz"), **out)
    return {}


# ---------------------------------------------------------------------------
# s4: the cases of tests/test_link_pipeline.py
# ---------------------------------------------------------------------------
def _pipelined_and_fused(stages, n_bits=N_BITS, **kw):
    link, params = _port()
    spec = make_spec(link, stages, **kw)
    return (link.build_link(spec, n_bits, params, span_mesh=_CTX["mesh"]),
            link.build_link(spec, n_bits, params, device="cpu"))


def check_config4_matches_sequential_fused(ctx):
    pp, ps = _pipelined_and_fused(CONFIG4)
    sw_p = pp.dsp_wdm(8, seed=0, nslots=N_BITS)
    sw_s = ps.dsp_wdm(8, bits=sw_p.tx, seed=0, nslots=N_BITS)
    np.testing.assert_array_equal(sw_p.ber, sw_s.ber)
    assert (sw_p.ber == 0).all()    # DBP inverted the spans -> clean
    np.testing.assert_allclose(sw_p.threshold, sw_s.threshold, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(sw_p.mu1, sw_s.mu1, rtol=1e-4)
    np.testing.assert_allclose(sw_p.eye_h, sw_s.eye_h, rtol=5e-3)
    return {}


def check_noisy_reproducible(ctx):
    pp, _ = _pipelined_and_fused(NOISY8, include_thermal=True,
                                 include_shot=True)
    r1 = pp.dsp_wdm(8, seed=1, nslots=N_BITS)
    r2 = pp.dsp_wdm(8, seed=1, nslots=N_BITS)
    np.testing.assert_array_equal(r1.threshold, r2.threshold)
    np.testing.assert_array_equal(r1.n_errors, r2.n_errors)
    r3 = pp.dsp_wdm(8, bits=r1.tx, seed=99, nslots=N_BITS)
    assert not np.array_equal(r1.threshold, r3.threshold)
    assert np.isfinite(r1.threshold).all() and r1.rin_ok.all()
    return {}


def check_validation(ctx):
    link, params = _port()
    mesh = ctx["mesh"]
    pp, _ = _pipelined_and_fused(CONFIG4)
    _raises(ValueError, "multiple", lambda: pp.dsp_wdm(3))
    _raises(ValueError, "multiple", lambda: pp.dsp_wdm(0))
    _raises(ValueError, "bits must have shape",
            lambda: pp.dsp_wdm(4, bits=np.zeros((4, 17))))
    _raises(ValueError, "noise must be a list of 4",
            lambda: pp.dsp_wdm(4, noise=[{}]))
    _raises(ValueError, "`M` must be a power of 2",
            lambda: pp.dsp_wdm_ppm(4, M=3))
    _raises(ValueError, '"hard" or "soft"',
            lambda: pp.dsp_wdm_ppm(4, M=8, decision="maybe"))
    _raises(ValueError, "not both", lambda: link.build_link(
        make_spec(link, CONFIG4), N_BITS, params, mesh=mesh,
        span_mesh=mesh))
    _raises(ValueError, "the mesh computes on", lambda: link.build_link(
        make_spec(link, CONFIG4), N_BITS, params, span_mesh=mesh,
        device="meta"))
    _raises(ValueError, "no axis 'ch'", lambda: link.build_link(
        make_spec(link, CONFIG4), N_BITS, params, span_mesh=mesh,
        span_axis="ch"))
    assert type(pp).__name__ == "PipelinedLinkProgram" and pp.S == 4
    return {}


def check_adc_matches_fused(ctx):
    link, params = _port()
    pp, ps = _pipelined_and_fused(CONFIG4, adc_bits=6)
    sw_p = pp.dsp_wdm(8, seed=0, nslots=N_BITS)
    sw_s = ps.dsp_wdm(8, bits=sw_p.tx, seed=0, nslots=N_BITS)
    np.testing.assert_array_equal(sw_p.ber, sw_s.ber)
    np.testing.assert_allclose(sw_p.threshold, sw_s.threshold, rtol=1e-4,
                               atol=1e-6)
    # quantisation really happened: a coarse ADC moves the levels
    sw_u = link.build_link(make_spec(link, CONFIG4), N_BITS, params,
                           device="cpu").dsp_wdm(8, bits=sw_p.tx, seed=0,
                                                 nslots=N_BITS)
    assert not np.allclose(sw_s.mu1, sw_u.mu1, rtol=1e-6)
    return {}


def check_seed_sweep_reuses_runner(ctx):
    pp, _ = _pipelined_and_fused(NOISY8)
    r0 = pp.dsp_wdm(8, seed=0, nslots=N_BITS)
    n_progs = len(pp._dsp_cache)
    r1 = pp.dsp_wdm(8, bits=r0.tx, seed=1, nslots=N_BITS)
    r2 = pp.dsp_wdm(8, bits=r0.tx, seed=2, nslots=N_BITS)
    assert len(pp._dsp_cache) == n_progs == 1   # no new runner per seed
    assert not np.array_equal(r1.threshold, r2.threshold)   # noise moved
    return {}


def check_ppm_soft_and_hard(ctx):
    M, n_sym = 8, 64
    stages = (("repeat", (8, (("fiber", dict(length=10, alpha=0.2,
                                             beta_2=-21.0, gamma=1.3,
                                             h=1.0)),
                              ("edfa", dict(G=2.0))))),)
    pp, ps = _pipelined_and_fused(stages, n_bits=n_sym * M)
    for decision in ("soft", "hard"):
        sw = pp.dsp_wdm_ppm(8, M=M, decision=decision, seed=0,
                            nslots=n_sym * M)
        assert sw.ber.shape == (8,) and (sw.ber == 0).all(), decision
        sw0 = ps.dsp_wdm_ppm(8, M=M, decision=decision, bits=sw.tx, seed=0,
                             nslots=n_sym * M)
        np.testing.assert_array_equal(sw0.ber, sw.ber)
        if decision == "hard":
            assert sw.threshold is not None
            np.testing.assert_allclose(sw.threshold, sw0.threshold,
                                       rtol=1e-3, atol=1e-6)
            assert sw.n_repaired.shape == (8,)
            np.testing.assert_array_equal(sw.n_repaired, sw0.n_repaired)
        else:
            assert sw.threshold is None
            assert sw.n_repaired is None and sw0.n_repaired is None
    return {}


def run_matrix_case(ctx, name):
    pp, ps = _pipelined_and_fused(MATRIX[name])
    sw_p = pp.dsp_wdm(8, seed=0, nslots=N_BITS)
    sw_s = ps.dsp_wdm(8, bits=sw_p.tx, seed=0, nslots=N_BITS)
    np.testing.assert_array_equal(sw_p.ber, sw_s.ber)
    np.testing.assert_allclose(sw_p.threshold, sw_s.threshold, rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(sw_p.mu1, sw_s.mu1, rtol=1e-3, atol=1e-7)
    return {"max_rel_mu1": float(np.max(np.abs(sw_p.mu1 / sw_s.mu1 - 1)))}


def check_mesh_ppermute(ctx):
    """LinkMesh.ppermute: the ring, the open chain (the first rank gets
    None), complex payloads and the axis's first collective, on 4
    ranks."""
    import torch
    mesh, r = ctx["mesh"], ctx["rank"]
    x = torch.full((3,), complex(r, -r), dtype=torch.complex64)
    ring = mesh.ppermute(x, "span", [(i, (i - 1) % 4) for i in range(4)])
    assert ring.tolist() == [complex((r + 1) % 4, -((r + 1) % 4))] * 3
    # the axis had its one collective before its first point-to-point call
    assert mesh._p2p_ready == {"span"}
    chain = mesh.ppermute(x.real.contiguous(), "span",
                          [(i, i + 1) for i in range(3)])
    assert (chain is None) if r == 0 else chain.tolist() == [r - 1.0] * 3
    self_ = mesh.ppermute(x, "span", [(r2, r2) for r2 in range(4)])
    assert torch.equal(self_, x) and self_.data_ptr() != x.data_ptr()
    _raises(ValueError, "more than once",
            lambda: mesh.ppermute(x, "span", [(0, 1), (0, 2)]))
    return {}


_CTX = {}
CHECKS_S4 = {
    "span_pipeline_matches_sequential": check_span_pipeline_matches_sequential,
    "span_pipeline_sharded_output": check_span_pipeline_sharded_output,
    "span_pipeline_rejects_indivisible_batch":
        check_span_pipeline_rejects_indivisible_batch,
    "span_pipeline_keyed_ase": check_span_pipeline_keyed_ase,
    "span_pipeline_adaptive": check_span_pipeline_adaptive,
    "stages_config4_matches_fused_link":
        check_stages_config4_matches_fused_link,
    "stages_dm_and_attenuator": check_stages_dm_and_attenuator,
    "stages_keyed_ase_schedule": check_stages_keyed_ase_schedule,
    "stages_validation": check_stages_validation,
    "jax_inputs": run_jax_inputs,
    "config4_matches_sequential_fused": check_config4_matches_sequential_fused,
    "noisy_reproducible": check_noisy_reproducible,
    "validation": check_validation,
    "adc_matches_fused": check_adc_matches_fused,
    "seed_sweep_reuses_runner": check_seed_sweep_reuses_runner,
    "ppm_soft_and_hard": check_ppm_soft_and_hard,
    "mesh_ppermute": check_mesh_ppermute,
}


# ---------------------------------------------------------------------------
# s1: world size 1
# ---------------------------------------------------------------------------
def check_single_span(ctx):
    """S = 1 is plain propagation a microbatch (the ring a local copy)."""
    from opticomlib_tpu_torch.parallel import span_pipeline
    A = batch(3, 512, 4)
    cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5)
    out = np.asarray(span_pipeline(A, ctx["mesh"], 80e9, 2.0, **cfg))
    expect = _sequential_spans(A, 1, 80e9, 2.0, **cfg)
    return {"err": _peak_close(out, expect, 5e-4)}


def check_make_span_mesh(ctx):
    from opticomlib_tpu_torch.parallel import make_span_mesh
    mesh = make_span_mesh(1)
    assert mesh.axis_names == ("span",) and mesh.shape == {"span": 1}
    assert mesh is ctx["mesh"]
    _raises(ValueError, "2 spans need 2 devices, have 1",
            lambda: make_span_mesh(2))
    _raises(ValueError, "3 spans need 3 devices, have 1",
            lambda: make_span_mesh(3, devices=[0]))
    return {}


CHECKS_S1 = {
    "single_span": check_single_span,
    "stages_keyed_ase_schedule": check_stages_keyed_ase_schedule,
    "make_span_mesh": check_make_span_mesh,
    "config4_matches_sequential_fused": check_config4_matches_sequential_fused,
}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rendezvous, out_dir, suite = sys.argv[3], sys.argv[4], sys.argv[5]
    start = int(sys.argv[6]) if len(sys.argv) > 6 else 0

    import torch
    torch.set_num_threads(1)
    from _torch_dist_items import run_items
    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_span_mesh)

    # a hung collective fails after a minute instead of waiting
    n = initialize_multihost(f"file://{rendezvous}", world, rank,
                             device="cpu", timeout_s=60)
    assert n == world
    ctx = dict(rank=rank, world=world, mesh=make_span_mesh(world),
               out=out_dir)
    _CTX.update(ctx)
    todo = [(name, lambda fn=fn: fn(ctx)) for name, fn in
            (CHECKS_S4 if suite == "s4" else CHECKS_S1).items()]
    if suite == "s4":
        todo += [(f"matrix_{k}", lambda k=k: run_matrix_case(ctx, k))
                 for k in MATRIX]
    run_items(todo, rank, world, out_dir, start)


if __name__ == "__main__":
    main()
