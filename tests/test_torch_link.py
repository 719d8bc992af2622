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
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _jax_draws(seed, n, n_noisy_edfa):
    """Unit-normal draws of the JAX program's key stream (link.py fwd):
    k_laser first, one key per noisy EDFA ((4, n) draw), then k_pd split
    into the thermal and shot keys."""
    stream = jax.random.PRNGKey(np.uint32(seed))
    stream, _k_laser = jax.random.split(stream)
    ase = []
    for _ in range(n_noisy_edfa):
        stream, k = jax.random.split(stream)
        ase.append(np.asarray(jax.random.normal(k, (4, n), jnp.float32)))
    stream, k_pd = jax.random.split(stream)
    k_T, k_N = jax.random.split(k_pd)
    return {"ase": ase,
            "thermal": np.asarray(jax.random.normal(k_T, (n,), jnp.float32)),
            "shot": np.asarray(jax.random.normal(k_N, (n,), jnp.float32))}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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
    assert _rel_l2(res.v.numpy(), v_j) <= 1e-4
    assert _rel_l2(res.slots.numpy(), slots_j) <= 1e-4
    assert len(res.n_steps) == 1 and res.n_steps[0] > 0


def test_noisy_chain_matches_jax_on_jax_draws(noisy):
    _, jprog, tprog, bits = noisy
    draws = _jax_draws(SEED, tprog.n, n_noisy_edfa=1)
    v_j = jprog.jitted(jnp.asarray(bits.astype(np.float32)),
                       jnp.uint32(SEED))[0]
    res = tprog.run(bits=bits, noise=draws)
    assert _rel_l2(res.v.numpy(), v_j) <= 1e-4


def test_noisy_dsp_matches_jax_on_jax_draws(noisy):
    _, jprog, tprog, bits = noisy
    dj = jprog.dsp(bits=bits, seed=SEED)
    dt = tprog.dsp(bits=bits, noise=_jax_draws(SEED, tprog.n, 1))
    assert dt.n_errors == dj.n_errors
    scan_step = abs(dj.eye.mu1 - dj.eye.mu0) / 999
    assert abs(dt.threshold - dj.threshold) <= scan_step * (1 + 1e-3)
    for k in ("mu0", "mu1", "s0", "s1", "threshold", "t_opt", "er"):
        np.testing.assert_allclose(getattr(dt.eye, k), getattr(dj.eye, k),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert dt.eye.i == dj.eye.i


def test_unported_options_raise():
    fib = tlink.FiberSpec(length=1.0, gamma=1.3, beta_2=-21.0)
    for kw in (dict(lw=1e5), dict(rin=-150.0), dict(df=1e9),
               dict(modulator="pm"), dict(adc_bits=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tlink.LinkSpec(stages=(fib,), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlink.LinkSpec(stages=(jlink.DMSpec(D=1.0),))
    params = TParams.create(sps=8, R=R, _warn=False)
    for st in (dataclasses.replace(fib, method="o4", h=0.5),
               dataclasses.replace(fib, method="local_error"),
               tlink.EDFASpec(G=10, NF=5, BW=50e9)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tlink.build_link(tlink.LinkSpec(stages=(st,)), 64, params,
                             device="cpu")


def test_seeded_noise_is_reproducible():
    _, tprog, bits = _build("entry", noisy=True)
    v1 = tprog.run(bits=bits, seed=5).v
    v2 = tprog.run(bits=bits, seed=5).v
    v3 = tprog.run(bits=bits, seed=6).v
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
    assert _rel_l2(res.v.numpy(), v_j) <= 1e-4
    assert _rel_l2(res.slots.numpy(), slots_j) <= 1e-4
