"""The port's fused link (opticomlib_tpu_torch.link) against the JAX
package's (opticomlib_tpu.link) on three configurations:

* ``entry``: the repository entry point's link (__graft_entry__.entry: 2^10
  bits, sps 16, 50 km at fixed h = 1.0 km, EDFA G 10 dB NF 5 dB);
* ``config2``: BASELINE config 2 as bench.py builds it (P0 16 dBm, 50 km
  phi_max-adaptive, EDFA G 10 dB NF 5 dB), cut to 2^10 bits at sps 64;
* ``linear``: the entry link with gamma = 0 (one exact dispersion step).

Checks: the two programs' spectral constants agree (rel 1e-6); the
noiseless chain agrees (rel L2 <= 1e-4 on ``v`` and the slot samples); fed
the JAX program's own noise draws, rebuilt here along its key stream, the
noisy chain agrees (rel L2 <= 1e-4 on ``v``) and ``dsp`` gives the same
error count, a threshold within one step of its 1000-point scan, and eye
scalars within rel 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, rel_l2

from opticomlib_tpu import link as jlink
from opticomlib_tpu.params import SimParams as JParams
from opticomlib_tpu_torch import convert
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch.params import SimParams as TParams

torch.set_num_threads(2)

R = 10e9
CONFIGS = {
    "entry": dict(n_bits=2**10, sps=16, P0=5.0, h=1.0, gamma=1.3),
    "config2": dict(n_bits=2**10, sps=64, P0=16.0, h=None, gamma=1.3),
    # a dispersion-only span: one exact linear step, no adaptation
    "linear": dict(n_bits=2**9, sps=16, P0=5.0, h=None, gamma=0.0),
}
SEED = 3


def _specs(cfg, noisy):
    """The same link as a JAX spec and as a port spec."""
    out = []
    for mod in (jlink, tlink):
        stages = (mod.FiberSpec(length=50, alpha=0.2, beta_2=-21.0,
                                gamma=cfg["gamma"], h=cfg["h"]),
                  mod.EDFASpec(G=10, NF=5 if noisy else None))
        out.append(mod.LinkSpec(
            Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=cfg["P0"],
            pulse_shape="gaussian", loss_dB=3, ER_dB=26, stages=stages,
            pd_BW=0.75 * R, include_thermal=noisy, include_shot=noisy))
    return out


def _build(name, noisy):
    cfg = CONFIGS[name]
    js, ts = _specs(cfg, noisy)
    jprog = jlink.build_link(js, cfg["n_bits"], params=JParams.create(
        sps=cfg["sps"], R=R, _warn=False))
    tprog = tlink.build_link(ts, cfg["n_bits"], TParams.create(
        sps=cfg["sps"], R=R, _warn=False), device="cpu")
    bits = np.random.default_rng(0).integers(0, 2, cfg["n_bits"]).astype(
        np.uint8)
    return jprog, tprog, bits


@pytest.fixture(scope="module", params=list(CONFIGS))
def noisy(request):
    return (request.param,) + _build(request.param, noisy=True)


@pytest.fixture(scope="module", params=list(CONFIGS))
def noiseless(request):
    return (request.param,) + _build(request.param, noisy=False)


def test_constants_carried_across(noisy):
    _, jprog, tprog, _ = noisy
    carried = convert.consts_from_jax(
        {k: np.asarray(v) for k, v in jprog.consts.items()})
    own = dict(tprog.named_buffers())
    assert set(carried) == set(own) == {"Hp", "phi_w_0", "H2_pd"}
    for k, v in carried.items():
        assert v.dtype == own[k].dtype
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(v.abs().max()))
    tprog.load_consts(carried)
    for k, v in carried.items():
        assert torch.equal(getattr(tprog, k), v)


def test_noiseless_chain_matches_jax(noiseless):
    _, jprog, tprog, bits = noiseless
    v_j, slots_j = jprog.jitted(jnp.asarray(bits.astype(np.float32)),
                                jnp.uint32(SEED))[:2]
    res = tprog.run(bits=bits, seed=SEED)
    assert rel_l2(res.v.to_numpy(), v_j) <= 1e-4
    assert rel_l2(res.slots.to_numpy(), slots_j) <= 1e-4
    assert len(res.n_steps) == 1 and res.n_steps[0] > 0


def test_noisy_chain_matches_jax_on_jax_draws(noisy):
    _, jprog, tprog, bits = noisy
    draws = jax_draws(SEED, tprog.n, jprog.spec)
    v_j = jprog.jitted(jnp.asarray(bits.astype(np.float32)),
                       jnp.uint32(SEED))[0]
    res = tprog.run(bits=bits, noise=draws)
    assert rel_l2(res.v.to_numpy(), v_j) <= 1e-4


def test_noisy_dsp_matches_jax_on_jax_draws(noisy):
    _, jprog, tprog, bits = noisy
    dj = jprog.dsp(bits=bits, seed=SEED)
    dt = tprog.dsp(bits=bits, noise=jax_draws(SEED, tprog.n, jprog.spec))
    assert dt.n_errors == dj.n_errors
    scan_step = abs(dj.eye.mu1 - dj.eye.mu0) / 999
    assert abs(dt.threshold - dj.threshold) <= scan_step * (1 + 1e-3)
    for k in ("mu0", "mu1", "s0", "s1", "threshold", "t_opt", "er"):
        np.testing.assert_allclose(getattr(dt.eye, k), getattr(dj.eye, k),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert dt.eye.i == dj.eye.i


@pytest.mark.parametrize("make,match", [
    (lambda m: m.LinkSpec(pulse_shape="gausian"), "pulse_shape"),
    (lambda m: m.LinkSpec(coupling="CA"), "coupling"),
    (lambda m: m.LinkSpec(modulator="eam"), "modulator"),
    (lambda m: m.LinkSpec(stages=("fiber",)), "unsupported stage"),
    (lambda m: m.LinkSpec(adc_bits=40), "adc_bits"),
    (lambda m: m.LinkSpec(Vpi=0.0), "Vpi"),
    (lambda m: m.FiberSpec(length=-1.0), "length"),
    (lambda m: m.FiberSpec(length=10, h=1.0, method="rk4"), "method"),
    (lambda m: m.FiberSpec(length=10, method="local_error", h=1.0),
     "adaptive"),
    (lambda m: m.FiberSpec(length=10, tol=0.0), "tol"),
    (lambda m: m.RepeatSpec(2, (m.RepeatSpec(2, (m.FiberSpec(length=1.0),)),
                                )), "nest"),
    (lambda m: m.RepeatSpec(0, (m.FiberSpec(length=1.0),)), "RepeatSpec.n"),
    (lambda m: m.RepeatSpec(2, ()), "non-empty"),
    (lambda m: m.BPFSpec(BW=0.0), "BW"),
    (lambda m: m.EDFASpec(G=10, BW=-1.0), "BW"),
])
def test_validation_matches_jax(make, match):
    """Every option the JAX package accepts is ported, so the port refuses
    exactly what JAX refuses, with the same message (tests/
    test_link_stages.py:170-186 and the spec validators)."""
    for mod in (jlink, tlink):
        with pytest.raises(ValueError, match=match):
            make(mod)


@pytest.mark.parametrize("kw,stages,match", [
    ({}, lambda m: (m.EDFASpec(G=-3.0, NF=5.0),), "G >= 0"),
    (dict(rin=-90.0), lambda m: (), "RIN"),
])
def test_build_time_validation_matches_jax(kw, stages, match):
    for mod, P, dev in ((jlink, JParams, {}), (tlink, TParams,
                                             {"device": "cpu"})):
        spec = mod.LinkSpec(stages=stages(mod), **kw)
        with pytest.raises(ValueError, match=match):
            mod.build_link(spec, 64, params=P.create(sps=8, R=R,
                                                     _warn=False), **dev)


def test_seeded_noise_is_reproducible():
    _, tprog, bits = _build("entry", noisy=True)
    v1 = tprog.run(bits=bits, seed=5).v.signal
    v2 = tprog.run(bits=bits, seed=5).v.signal
    v3 = tprog.run(bits=bits, seed=6).v.signal
    assert torch.equal(v1, v2) and not torch.equal(v1, v3)


def test_load_consts_touches_only_its_program():
    """The buffers are copies: loading constants into one program leaves a
    program built on the same (cached) filter responses unchanged."""
    _, a, _ = _build("entry", noisy=False)
    _, b, _ = _build("entry", noisy=False)
    before = {k: v.clone() for k, v in b.named_buffers()}
    a.load_consts({k: v * 0.5 for k, v in a.named_buffers()})
    for k, v in b.named_buffers():
        assert torch.equal(v, before[k])
    with pytest.raises(ValueError):
        a.load_consts({"Hp": a.Hp})


@pytest.mark.parametrize("tx", [
    dict(pulse_shape="nrz"),
    dict(pulse_shape="rcos", pulse_kwargs=(("beta", 0.3),)),
    dict(pulse_shape="gaussian", pulse_kwargs=(("c", 0.4), ("m", 2))),
    dict(coupling="AC", sampler_instant=3),
])
def test_transmitter_options_match_jax(tx):
    """Pulse shapes (a chirped gaussian has complex taps), AC coupling and
    a sampling instant, through a short dispersive span, noiseless."""
    params = dict(sps=8, R=R, _warn=False)
    progs = []
    for mod, P, kw in ((jlink, JParams, {}), (tlink, TParams,
                                            {"device": "cpu"})):
        spec = mod.LinkSpec(
            Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=3.0, pd_BW=0.75 * R,
            stages=(mod.FiberSpec(length=5, beta_2=-21.0),),
            include_thermal=False, include_shot=False, **tx)
        progs.append(mod.build_link(spec, 256, params=P.create(**params),
                                    **kw))
    bits = np.random.default_rng(1).integers(0, 2, 256).astype(np.uint8)
    v_j, slots_j = progs[0].jitted(jnp.asarray(bits.astype(np.float32)),
                                   jnp.uint32(0))[:2]
    res = progs[1].run(bits=bits)
    assert rel_l2(res.v.to_numpy(), v_j) <= 1e-4
    assert rel_l2(res.slots.to_numpy(), slots_j) <= 1e-4


def _span_link(shape):
    """A config-2-shaped link (50 km of phi_max-adaptive NLSE, a noisy
    EDFA; 2^10 bits at sps 64) or a config-4-shaped one (20 x (80 km of
    fixed-step o4 + a noisy EDFA), 20 DBP spans, a noisy laser, an 8-bit
    ADC; 2^9 bits at sps 16), on the CPU."""
    from opticomlib_tpu_torch.utils import profiling
    span = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
    if shape == "config2":
        n_bits, sps, extra = 2**10, 64, {}
        stages = (tlink.FiberSpec(length=50, **span),
                  tlink.EDFASpec(G=10, NF=5))
    else:
        n_bits, sps = 2**9, 16
        extra = dict(lw=1e5, rin=-150.0, adc_bits=8)
        stages = (tlink.RepeatSpec(n=20, stages=(
                      tlink.FiberSpec(length=80, h=20.0, method="o4", **span),
                      tlink.EDFASpec(G=16, NF=5))),
                  tlink.RepeatSpec(n=20, stages=(
                      tlink.DBPSpec(length=80, h=20.0, method="o4",
                                    undo_gain_dB=16, **span),)))
    spec = tlink.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0 if shape == "config2"
        else 10.0, pulse_shape="gaussian", loss_dB=3, ER_dB=26,
        stages=stages, pd_BW=0.75 * R, **extra)
    profiling.record(True)
    try:
        prog = tlink.build_link(spec, n_bits, TParams.create(
            sps=sps, R=R, _warn=False), device="cpu")
        (build,) = profiling.drain()
    finally:
        profiling.record(False)
    assert build["name"] == "setup.build_link" and build["parent"] is None
    assert build["attrs"] == {"n": n_bits * sps}
    bits = np.random.default_rng(2).integers(0, 2, n_bits).astype(np.uint8)
    return prog, bits


def _dsp_recorded(prog, call):
    from opticomlib_tpu_torch.utils import profiling
    profiling.record(True)
    try:
        res = call()
        recs = profiling.drain()
    finally:
        profiling.record(False)
    return res, recs


@pytest.mark.parametrize("shape,n_fiber,n_stage", [("config2", 1, 1),
                                                   ("config4", 40, 20)])
def test_dsp_span_tree(shape, n_fiber, n_stage):
    """``dsp`` records one ``call.dsp`` root and, under it, ``tx``, a
    ``fiber`` span a fiber or DBP span (with the steps ``dsp`` returns) and
    a ``stage`` span every other stage, in the order they run, ``rx.pd``,
    ``rx.eye``, ``rx.decide`` and ``rx.readback``; its answers are the bits
    of the same call with recording off."""
    prog, bits = _span_link(shape)
    res, recs = _dsp_recorded(prog, lambda: prog.dsp(bits=bits, seed=SEED))
    off = prog.dsp(bits=bits, seed=SEED)
    for k in ("ber", "n_errors", "threshold", "n_steps", "rin_ok"):
        assert getattr(res, k) == getattr(off, k), k
    for k in ("mu0", "mu1", "s0", "s1", "threshold", "er", "eye_h"):
        a, b = getattr(res.eye, k, None), getattr(off.eye, k, None)
        assert a == b or (a is None and b is None), k

    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "call.dsp" and root["attrs"] == {"n": prog.n}
    assert all(r["call"] == root["id"] for r in recs)
    assert all(r["parent"] == root["id"] for r in recs if r is not root)
    order = [r["name"] for r in sorted(recs, key=lambda r: r["t0_ns"])]
    assert order[0] == "call.dsp" and order[1] == "tx"
    assert order[-4:] == ["rx.pd", "rx.eye", "rx.decide", "rx.readback"]
    fibers = [r for r in sorted(recs, key=lambda r: r["t0_ns"])
              if r["name"] == "fiber"]
    stages = [r for r in recs if r["name"] == "stage"]
    assert len(fibers) == n_fiber == len(res.n_steps)
    assert len(stages) == n_stage
    assert [f["attrs"]["steps"] for f in fibers] == list(res.n_steps)
    assert all(s["attrs"] == {"kind": "edfa"} for s in stages)
    if shape == "config2":
        assert fibers[0]["attrs"]["kind"] == "fiber"
        assert fibers[0]["attrs"]["steps"] > 10          # adaptive
    else:
        kinds = [f["attrs"]["kind"] for f in fibers]
        assert kinds == ["fiber"] * 20 + ["dbp"] * 20
        assert all(f["attrs"] == dict(kind=f["attrs"]["kind"], method="o4",
                                      steps=4) for f in fibers)
        assert set(order[2:-4]) == {"fiber", "stage"}


def test_dsp_wdm_span_tree():
    """A sweep records one ``call.dsp_wdm`` root; each channel's chain
    under it, the stacked receivers in ``rx.eye`` (a ``rx.decide`` a
    channel) and the one read-back of the rows in ``rx.readback``."""
    prog, bits = _span_link("config2")
    two = np.stack([bits, bits[::-1]])
    res, recs = _dsp_recorded(prog, lambda: prog.dsp_wdm(
        2, bits=two, seed=SEED))
    off = prog.dsp_wdm(2, bits=two, seed=SEED)
    assert np.array_equal(res.threshold, off.threshold)
    assert res.n_steps == off.n_steps
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "call.dsp_wdm"
    assert root["attrs"] == {"n": prog.n, "channels": 2}
    names = [r["name"] for r in recs]
    assert names.count("tx") == names.count("rx.pd") == 2
    assert names.count("fiber") == names.count("stage") == 2
    assert names.count("rx.eye") == names.count("rx.readback") == 1
    (eye,) = [r for r in recs if r["name"] == "rx.eye"]
    decides = [r for r in recs if r["name"] == "rx.decide"]
    assert len(decides) == 2 and all(d["parent"] == eye["id"]
                                     for d in decides)
    assert [f["attrs"]["steps"] for f in sorted(
        (r for r in recs if r["name"] == "fiber"),
        key=lambda r: r["t0_ns"])] == [s[0] for s in res.n_steps]
