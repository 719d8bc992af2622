"""The long-haul link of BASELINE config 4 in the port against the JAX
package, cut to 2 + 2 spans and 256 bits at 16 samples per bit:
RepeatSpec(FiberSpec(80 km, o4, h = 20 km) + EDFASpec(16 dB, NF 5 dB)),
RepeatSpec(DBPSpec(..., undo_gain_dB=16)), laser linewidth and RIN, and a
6-bit ADC, with the JAX key stream's draws replayed through ``noise=``.
``dsp`` must give the same error count and a threshold within one step of
the 1000-point scan; the waveform agrees to relative L2 1e-4 before the
ADC, and after it every sample but those on a decision boundary keeps its
code.

Also here: the laser's phase noise, RIN and frequency offset on injected
draws (field within relative L2 1e-5: the Wiener phase is a float32 cumsum
that torch and XLA sum in different orders), the RIN clamp flag, and the
constants of a program that mixes ``phi_w``, ``phi_dm`` and ``H2_bpf``
carried across by ``convert.consts_from_jax``.
"""
import dataclasses

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

SPS, R = 16, 10e9
N_BITS = 256
SEED = 3
BITS = np.random.default_rng(5).integers(0, 2, N_BITS).astype(np.uint8)


def _config4(mod, n_spans=2, **kw):
    span = dict(length=80, alpha=0.2, beta_2=-21.0, gamma=1.3, method="o4",
                h=20.0)
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=10.0,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26, lw=1e5,
                rin=-150.0, pd_BW=0.75 * R, adc_bits=6)
    base.update(kw)
    return mod.LinkSpec(stages=(
        mod.RepeatSpec(n_spans, (mod.FiberSpec(**span),
                                 mod.EDFASpec(G=16, NF=5))),
        mod.RepeatSpec(n_spans, (mod.DBPSpec(undo_gain_dB=16, **span),))),
        **base)


def _programs(make, return_field=False):
    jspec, tspec = make(jlink), make(tlink)
    jprog = jlink.build_link(jspec, N_BITS, params=JParams.create(
        sps=SPS, R=R, _warn=False), return_field=return_field)
    tprog = tlink.build_link(tspec, N_BITS, TParams.create(
        sps=SPS, R=R, _warn=False), device="cpu", return_field=return_field)
    return jprog, tprog


@pytest.fixture(scope="module")
def config4():
    return _programs(_config4)


def test_config4_dsp_matches_jax(config4):
    jprog, tprog = config4
    dj = jprog.dsp(bits=BITS, seed=SEED)
    dt = tprog.dsp(bits=BITS, noise=jax_draws(SEED, tprog.n, jprog.spec))
    assert dt.n_errors == dj.n_errors
    assert dt.rin_ok and dj.rin_ok
    assert dt.n_steps == (4,) * 4  # 2 forward + 2 DBP spans of 80/20 km
    scan_step = abs(dj.eye.mu1 - dj.eye.mu0) / 999
    assert abs(dt.threshold - dj.threshold) <= scan_step * (1 + 1e-3)


def test_config4_waveform_matches_jax(config4):
    """Before the ADC the voltages agree to float32 round-off over 16
    o4 steps; the 6-bit ADC then maps them to the same code except where a
    sample sits within that round-off of a decision boundary, where the code
    moves by one level."""
    jprog, tprog = config4
    unquantised = _programs(lambda m: _config4(m, adc_bits=None))
    for (jp, tp), adc in ((config4, True), (unquantised, False)):
        v_j = np.asarray(jp.jitted(jnp.asarray(BITS.astype(np.float32)),
                                   jnp.uint32(SEED))[0])
        v_t = tp.run(bits=BITS, noise=jax_draws(SEED, tp.n, jp.spec)
                     ).v.to_numpy()
        if not adc:
            assert rel_l2(v_t, v_j) <= 1e-4
            continue
        level = np.ptp(v_j) / 63
        moved = np.abs(v_t - v_j) > 0.5 * level  # a code one level apart
        assert moved.mean() <= 0.01
        assert np.abs(v_t - v_j).max() <= 1.5 * level
        assert len(np.unique(v_t)) <= 2 ** 6 + 8  # 6 bits (+ the tails)


def test_config4_noiseless_round_trip():
    """Without ASE and laser noise, per-span DBP undoes the spans: the
    field after 2 + 2 spans is the launch field (the round-trip target of
    EQUAL_ACCURACY.json, 0.01), in the port as in the JAX package."""
    def make(mod):
        spec = _config4(mod, lw=None, rin=None, adc_bits=None)
        stages = tuple(
            mod.RepeatSpec(st.n, tuple(
                mod.EDFASpec(G=s.G) if isinstance(s, mod.EDFASpec) else s
                for s in st.stages)) for st in spec.stages)
        return dataclasses.replace(spec, stages=stages)

    jprog, tprog = _programs(make, return_field=True)
    b2b = tlink.build_link(dataclasses.replace(
        make(tlink), stages=()), N_BITS, TParams.create(
            sps=SPS, R=R, _warn=False), device="cpu", return_field=True)
    f0 = b2b.run(bits=BITS).field.numpy()
    f_t = tprog.run(bits=BITS).field.numpy()
    out = jprog.jitted(jnp.asarray(BITS.astype(np.float32)), jnp.uint32(0))
    f_j = np.asarray(out[2]) + 1j * np.asarray(out[3])
    assert rel_l2(f_t, f_j) <= 1e-4
    assert rel_l2(f_t, f0) <= 0.01


@pytest.mark.parametrize("laser", [
    dict(lw=1e6), dict(rin=-140.0), dict(df=2e9),
    dict(lw=1e6, rin=-140.0, df=1e9),
    dict(lw=1e6, rin=-140.0, modulator="pm"),
])
def test_laser_noise_matches_jax_on_jax_draws(laser):
    def make(mod):
        return mod.LinkSpec(
            Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=3.0, pd_BW=0.75 * R,
            stages=(mod.FiberSpec(length=20, beta_2=-21.0),), **laser)
    jprog, tprog = _programs(make, return_field=True)
    out = jprog.jitted(jnp.asarray(BITS.astype(np.float32)),
                       jnp.uint32(SEED))
    f_j = np.asarray(out[2]) + 1j * np.asarray(out[3])
    res = tprog.run(bits=BITS, noise=jax_draws(SEED, tprog.n, jprog.spec))
    assert rel_l2(res.field.numpy(), f_j) <= 1e-5
    assert rel_l2(res.v.to_numpy(), np.asarray(out[0])) <= 1e-5
    assert res.rin_ok and float(out[-1]) == 1.0


def test_wiener_phase_walk_matches_jax():
    from opticomlib_tpu.ops import noise as jnoise
    from opticomlib_tpu_torch.ops import noise as tnoise
    import jax
    key = jax.random.PRNGKey(11)
    n, sigma = 2**16, 2e-3
    want = np.asarray(jnoise.wiener_phase_inside(key, n, sigma))
    d = np.asarray(jax.random.normal(key, (n,), jnp.float32))
    got = tnoise.wiener_phase(n, sigma, None, torch.tensor(d)).numpy()
    # a float32 walk summed in another order: within 1e-5 rad of it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1,), (1024,), (1025,), (2**16 + 3,),
                                   (3, 5000), (2, 1, 2**20)])
def test_running_sum_is_a_cumulative_sum(shape):
    """The blocked running sum of the laser walk: a cumulative sum over the
    last axis to float32 round-off of the float64 one, at the lengths
    around its 1024-sample block and with leading axes."""
    from opticomlib_tpu_torch.ops.noise import running_sum
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        shape, dtype=np.float32))
    got = running_sum(x)
    want = torch.cumsum(x.double(), dim=-1)
    assert got.shape == x.shape and got.dtype == torch.float32
    scale = float(want.abs().max()) + 1.0
    assert float((got.double() - want).abs().max()) <= 1e-6 * scale * (
        1 + np.log2(shape[-1]))


def test_rin_clamp_sets_the_flag_and_warns():
    """A RIN draw below -1 darkens its sample instead of NaN-ing the chain,
    and the run reports it (rin_ok False plus a RuntimeWarning)."""
    spec = tlink.LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=3.0,
                          rin=-140.0, include_thermal=False,
                          include_shot=False)
    prog = tlink.build_link(spec, N_BITS, TParams.create(
        sps=SPS, R=R, _warn=False), device="cpu")
    n = prog.n
    rin = np.zeros(n, np.float32)
    rin[100] = -1e4  # 1 + sigma*draw < 0
    with pytest.warns(RuntimeWarning, match="RIN"):
        res = prog.run(bits=BITS, noise={"rin": rin})
    assert not res.rin_ok
    assert np.isfinite(res.v.to_numpy()).all()
    assert prog.run(bits=BITS, noise={"rin": np.zeros(n, np.float32)}).rin_ok


def test_mixed_stage_constants_carried_across():
    """phi_w, phi_dm and H2_bpf share one name counter in stage order, and
    df_phase rides along: the port's buffers have the JAX names, so
    consts_from_jax loads a mixed program."""
    def make(mod):
        fib = mod.FiberSpec(length=10, beta_2=-21.0, gamma=1.3, h=5.0)
        return mod.LinkSpec(df=1e9, stages=(
            fib, mod.DMSpec(D=210.0), mod.EDFASpec(G=3.0, BW=0.5 * R),
            mod.BPFSpec(BW=0.6 * R), mod.DMSpec(D=210.0),
            mod.RepeatSpec(2, (fib, mod.BPFSpec(BW=0.7 * R))),
            mod.DBPSpec(length=10, beta_2=-21.0, gamma=1.3, h=5.0)))
    jprog, tprog = _programs(make)
    carried = convert.consts_from_jax(
        {k: np.asarray(v) for k, v in jprog.consts.items()})
    own = dict(tprog.named_buffers())
    assert set(carried) == set(own) == {
        "Hp", "df_phase", "phi_w_0", "phi_dm_1", "H2_bpf_2", "H2_bpf_3",
        "H2_bpf_4", "H2_pd"}
    for k, v in carried.items():
        assert v.dtype == own[k].dtype
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(v.abs().max()))
    tprog.load_consts(carried)
    v_j = jprog.jitted(jnp.asarray(BITS.astype(np.float32)),
                       jnp.uint32(SEED))[0]
    res = tprog.run(bits=BITS, noise=jax_draws(SEED, tprog.n, jprog.spec))
    assert rel_l2(res.v.to_numpy(), v_j) <= 1e-4
