"""The port's stage vocabulary (opticomlib_tpu_torch.link: DMSpec, BPFSpec,
EDFASpec noiseless and with an output filter, DBPSpec, RepeatSpec, the phase
modulator and the in-graph ADC), case for case as tests/test_link_stages.py
checks the JAX package's, and each against the JAX fused link on the same
input (256 bits at 16 samples per bit, noiseless unless stated).  The
validation cases of that file are in tests/test_torch_link.py
(``test_validation_matches_jax``, ``test_build_time_validation_matches_jax``).

Tolerances: the optical field before the photodiode within relative L2
1e-5 of the JAX field for the purely linear stages (one FFT pair each) and
1e-4 where split-step fiber runs (float32 FFT round-off over its steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, rel_l2

from opticomlib_tpu import link as jlink
from opticomlib_tpu.params import SimParams as JParams
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch.params import SimParams as TParams

torch.set_num_threads(2)

SPS, R = 16, 10e9
N_BITS = 256
BITS = np.random.default_rng(7).integers(0, 2, N_BITS).astype(np.uint8)


def _spec(mod, stages=(), **kw):
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                pd_BW=0.75 * R, include_thermal=False, include_shot=False)
    base.update(kw)
    return mod.LinkSpec(stages=tuple(stages), **base)


def _port(stages=lambda m: (), seed=0, noise=None, **kw):
    """The port's run (field, v, n_steps) for stages built by
    ``stages(tlink)``."""
    prog = tlink.build_link(_spec(tlink, stages(tlink), **kw), N_BITS,
                            TParams.create(sps=SPS, R=R, _warn=False),
                            device="cpu", return_field=True)
    res = prog.run(bits=BITS, seed=seed, noise=noise)
    return res.field.numpy(), res.v.to_numpy(), res.n_steps


def _jax(stages=lambda m: (), seed=0, **kw):
    """The JAX program's (field, v) and spec for stages built by
    ``stages(jlink)``."""
    spec = _spec(jlink, stages(jlink), **kw)
    prog = jlink.build_link(spec, N_BITS, params=JParams.create(
        sps=SPS, R=R, _warn=False), return_field=True)
    out = prog.jitted(jnp.asarray(BITS.astype(np.float32)), jnp.uint32(seed))
    field = np.asarray(out[2]) + 1j * np.asarray(out[3])
    return field, np.asarray(out[0]), spec


def _both(stages, tol, **kw):
    """Port and JAX fields of one link; asserts they agree to ``tol``."""
    f_j, v_j, _ = _jax(stages, **kw)
    f_t, v_t, _ = _port(stages, **kw)
    assert f_t.shape == f_j.shape
    assert rel_l2(f_t, f_j) <= tol
    assert rel_l2(v_t, v_j) <= tol
    return f_t


# --------------------------------------------------------------------- DM
def test_dm_stage_matches_jax():
    _both(lambda m: (m.DMSpec(D=336.0),), 1e-5)


def test_dm_compensates_linear_fiber():
    L, b2 = 40.0, -21.0
    f0 = _port()[0]
    f1 = _both(lambda m: (m.FiberSpec(length=L, beta_2=b2),
                          m.DMSpec(D=-b2 * L)), 1e-5)
    assert np.max(np.abs(f1 - f0)) < 1e-4 * np.max(np.abs(f0))


# -------------------------------------------------------------------- BPF
def test_bpf_stage_matches_jax():
    _both(lambda m: (m.BPFSpec(BW=0.6 * R),), 1e-5)


# ------------------------------------------------------------ EDFA extras
def test_edfa_noiseless_is_pure_scale():
    f0 = _port()[0]
    f1 = _both(lambda m: (m.EDFASpec(G=-6.0),), 1e-6)
    np.testing.assert_allclose(f1, f0 * 10 ** (-6.0 / 20), rtol=2e-6)


def test_edfa_output_filter_matches_jax():
    f_gain = _port(lambda m: (m.EDFASpec(G=3.0),))[0]
    f_filt = _both(lambda m: (m.EDFASpec(G=3.0, BW=0.5 * R),), 1e-5)
    assert rel_l2(f_filt, f_gain) > 1e-3  # the filter does act


def test_edfa_ase_needs_nonnegative_gain():
    with pytest.raises(ValueError, match="G >= 0"):
        _port(lambda m: (m.EDFASpec(G=-3.0, NF=5.0),))
    # G = 0 dB with NF set is legal (zero ASE), as in the staged EDFA
    f0 = _port()[0]
    f1 = _port(lambda m: (m.EDFASpec(G=0.0, NF=5.0),))[0]
    assert f1.shape == (2, f0.size)
    np.testing.assert_array_equal(f1[0], f0)
    assert not f1[1].any()


# -------------------------------------------------------------------- DBP
@pytest.mark.parametrize("method", ["reference", "o4"])
def test_dbp_stage_inverts_span(method):
    def stages(m):
        fib = m.FiberSpec(length=30.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                          h=0.25 if method == "reference" else 5.0,
                          method=method)
        G = fib.alpha * fib.length
        return (fib, m.EDFASpec(G=G),
                m.DBPSpec(length=fib.length, alpha=fib.alpha,
                          beta_2=fib.beta_2, gamma=fib.gamma, h=fib.h,
                          method=method, undo_gain_dB=G))
    f0 = _port()[0]
    f1 = _both(stages, 1e-4)
    err = np.max(np.abs(f1 - f0)) / np.max(np.abs(f0))
    assert err < 2e-3, err


def test_self_tuning_dbp_inverts_span():
    """FiberSpec/DBPSpec(method='o4', h=None) self-tune in the port as in
    the JAX link (tests/test_link_stages.py:317)."""
    kw = dict(length=40.0, alpha=0.2, beta_2=-21.0, gamma=1.3, method="o4",
              tol=1e-5)
    stages = (lambda m: (m.FiberSpec(**kw), m.DBPSpec(**kw)))
    f0 = _port()[0]
    f1 = _both(stages, 1e-4)
    assert rel_l2(f1, f0) < 5e-3


def test_local_error_stage_matches_reference_scheme():
    kw = dict(length=40.0, alpha=0.2, beta_2=-21.0, gamma=1.3)
    f_ref = _port(lambda m: (m.FiberSpec(phi_max=0.001, **kw),))[0]
    f_le = _both(lambda m: (m.FiberSpec(method="local_error", tol=1e-6,
                                        **kw),), 1e-4)
    assert rel_l2(f_le, f_ref) < 5e-3


# ----------------------------------------------------------------- Repeat
def test_repeat_noiseless_equals_unrolled():
    def fib_amp(m):
        return (m.FiberSpec(length=10.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                            h=1.0), m.EDFASpec(G=2.0))
    f_rep = _both(lambda m: (m.RepeatSpec(3, fib_amp(m)),), 1e-4)
    f_unr, _, steps = _port(lambda m: fib_amp(m) * 3)
    assert np.max(np.abs(f_rep - f_unr)) < 1e-5 * np.max(np.abs(f_unr))
    assert steps == (10, 10, 10)


def test_repeat_with_ase_reproducible_and_2pol():
    def stages(m):
        return (m.RepeatSpec(3, (m.FiberSpec(length=10.0, alpha=0.2,
                                             beta_2=-21.0, gamma=1.3, h=1.0),
                                 m.EDFASpec(G=2.0, NF=5.0))),)
    fa, fb, fc = (_port(stages, seed=s)[0] for s in (5, 5, 6))
    assert fa.shape[0] == 2  # promoted to 2 pol before the first span
    np.testing.assert_array_equal(fa, fb)
    assert np.max(np.abs(fa - fc)) > 0
    assert np.isfinite(fa).all()


def test_repeat_with_ase_matches_jax_on_jax_draws():
    """The JAX key stream of a repeat block (one block key, folded with the
    span index, split once per noisy EDFA), replayed through noise=."""
    def stages(m):
        return (m.EDFASpec(G=3.0, NF=6.0),
                m.RepeatSpec(2, (m.FiberSpec(length=10.0, alpha=0.2,
                                             beta_2=-21.0, gamma=1.3, h=2.0),
                                 m.EDFASpec(G=2.0, NF=5.0),
                                 m.EDFASpec(G=1.0, NF=4.0))))
    f_j, v_j, spec = _jax(stages, seed=9)
    draws = jax_draws(9, N_BITS * SPS, spec)
    assert len(draws["ase"]) == 5
    f_t, v_t, _ = _port(stages, noise=draws)
    assert rel_l2(f_t, f_j) <= 1e-4 and rel_l2(v_t, v_j) <= 1e-4


# --------------------------------------------------------------------- PM
def test_pm_modulator_phase():
    """Constant drive (NRZ, all-ones bits): the field is exactly
    sqrt(P0)*exp(j*pi*x/Vpi) with x = Vpp + offset."""
    prog = tlink.build_link(
        _spec(tlink, modulator="pm", pulse_shape="nrz", Vpp=2.0, offset=0.5),
        N_BITS, TParams.create(sps=SPS, R=R, _warn=False), device="cpu",
        return_field=True)
    f = prog.run(bits=np.ones(N_BITS, np.uint8)).field.numpy()
    from opticomlib_tpu_torch.utils.analysis import idbm
    expect = np.sqrt(idbm(5)) * np.exp(1j * np.pi * 2.5 / 5.0)
    np.testing.assert_allclose(f, np.full_like(f, expect), atol=2e-6)


def test_pm_modulator_matches_jax():
    _both(lambda m: (m.FiberSpec(length=20, beta_2=-21.0),), 1e-5,
          modulator="pm")


# -------------------------------------------------------------------- ADC
def test_adc_quantization_matches_jax():
    def stages(m):
        return (m.FiberSpec(length=20, alpha=0.2, beta_2=-21.0, gamma=1.3,
                            h=1.0),)
    _, v_raw, _ = _port(stages)
    _, v_adc_j, _ = _jax(stages, adc_bits=6)
    _, v_adc, _ = _port(stages, adc_bits=6)
    # the same code at every sample: the two voltages, and with them the
    # range and the levels, differ only by float32 round-off
    level = np.ptp(v_adc_j) / 63
    assert np.max(np.abs(v_adc - v_adc_j)) <= 1e-3 * level
    assert rel_l2(v_adc, v_adc_j) <= 1e-4
    assert len(np.unique(v_adc)) <= 2 ** 6
    assert np.max(np.abs(v_adc - v_raw)) <= 0.51 * np.ptp(v_raw) / 63
