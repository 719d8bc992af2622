"""The port's M-PPM stack against the JAX package's: the decision functions
on tensors (``opticomlib_tpu_torch.models.ppm``) against the ``_jax`` twins,
the host side (``PPM_ENCODER`` ... ``theory_BER``) against
``opticomlib_tpu.models.ppm``, and ``LinkProgram.dsp_ppm`` against the JAX
program's.

Sizes: M = 8, 2^9 symbols, sps 16.  Tolerances: decisions, decoded bits and
error counts equal (the JAX program's noise draws and its HDD uniform draws
are injected through ``noise=``); thresholds rel 1e-5 (a point of a grid
between two eye levels that agree to float32 reductions); eye scalars rel
1e-4.  Without injection the port draws from its own generators and is held
as ``tests/test_link_ppm.py`` holds the JAX program: against the host
pipeline on the same waveform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, jax_hdd_uniform

from opticomlib_tpu import gv as jgv
from opticomlib_tpu import link as jlink
from opticomlib_tpu.models import ppm as jppm
from opticomlib_tpu.signals import ElectricalSignal as JSignal
from opticomlib_tpu_torch import gv as tgv
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch import ppm as tppm_shim
from opticomlib_tpu_torch.eyediag import Eye as TEye
from opticomlib_tpu_torch.models import ppm as tppm
from opticomlib_tpu_torch.ops.prbs import prbs
from opticomlib_tpu_torch.params import SimParams as TParams
from opticomlib_tpu_torch.signals import ElectricalSignal as TSignal

torch.set_num_threads(2)

M, K, SPS, R = 8, 3, 16, 10e9
N_SYM = 2**9
N_SLOTS = N_SYM * M


@pytest.fixture(autouse=True)
def _reset():
    for g in (jgv, tgv):
        g.default()
        g(sps=SPS, R=R, N=N_SLOTS, Vpi=5)
    tgv.device = "cpu"
    yield
    jgv.default()
    tgv.default()


def _progs(**kw):
    base = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                pd_BW=0.75 * R, include_thermal=False, include_shot=False)
    base.update(kw)
    jprog = jlink.build_link(jlink.LinkSpec(**base), n_bits=N_SLOTS)
    tprog = tlink.build_link(tlink.LinkSpec(**base), N_SLOTS, TParams.create(
        sps=SPS, R=R, _warn=False), device="cpu")
    return jprog, tprog


def _bits():
    return prbs(15, length=N_SYM * K)[0]


def _noise(jprog, seed):
    d = jax_draws(seed, N_SLOTS * SPS, jprog.spec)
    d["hdd"] = jax_hdd_uniform(seed, N_SYM, M)
    return d


# ---------------------------------------------------------------------------
# decision functions
# ---------------------------------------------------------------------------
def test_sdd_positions_match_jax():
    x = np.random.default_rng(0).normal(0.2, 0.3, N_SLOTS).astype(np.float32)
    want = np.asarray(jppm.sdd_positions_jax(jnp.asarray(x), M))
    got = tppm.sdd_positions(torch.from_numpy(x), M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_ties_take_the_first_slot():
    """Noiseless OFF slots can tie exactly; JAX takes the first maximum."""
    x = np.zeros((4, M), np.float32)
    x[1, 3] = x[1, 5] = 1.0          # two equal maxima
    x[2, M - 1] = 2.0                # a single one, last
    x[3] = 0.7                       # a row of equal values
    want = np.asarray(jppm.sdd_positions_jax(jnp.asarray(x.ravel()), M))
    got = tppm.sdd_positions(torch.from_numpy(x.ravel()), M).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 3, M - 1, 0])


def test_hdd_positions_match_jax_on_its_draw():
    on = (np.random.default_rng(1).random(N_SLOTS) < 0.2).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(3)), 0x504D)
    want = np.asarray(jppm.hdd_positions_jax(jnp.asarray(on), M, key))
    got = tppm.hdd_positions(torch.from_numpy(on), M, torch.tensor(
        jax_hdd_uniform(3, N_SYM, M)))
    np.testing.assert_array_equal(got.numpy(), want)
    # one position a symbol; a symbol with ON slots keeps one of them
    on2 = on.reshape(-1, M)
    hit = on2[np.arange(N_SYM), got.numpy()]
    assert (hit[on2.sum(-1) >= 1] == 1).all()


def test_hdd_zero_on_symbols_spread_over_slots():
    on = torch.zeros(M * 256)
    g = torch.Generator().manual_seed(0)
    pos = tppm.hdd_positions(on, M, torch.rand((256, M), generator=g))
    assert len(np.unique(pos.numpy())) == M


def test_positions_to_bits_match_jax_and_decoder():
    pos = np.random.default_rng(2).integers(0, M, N_SYM).astype(np.int32)
    want = np.asarray(jppm.positions_to_bits_jax(jnp.asarray(pos), M))
    got = tppm.positions_to_bits(torch.from_numpy(pos), M)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    onehot = np.zeros(N_SLOTS, np.uint8)
    onehot[np.arange(N_SYM) * M + pos] = 1
    np.testing.assert_array_equal(got.numpy(),
                                  tppm.PPM_DECODER(onehot, M).data)


# ---------------------------------------------------------------------------
# the host side against opticomlib_tpu.models.ppm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("inp", ["0110 1001 0011", [1, 0, 1, 1, 1, 0, 0, 0, 1],
                                 "bits"])
def test_encoder_decoder_match_jax(inp):
    if inp == "bits":
        inp = _bits()
    enc_j, enc_t = jppm.PPM_ENCODER(inp, M), tppm.PPM_ENCODER(inp, M)
    np.testing.assert_array_equal(enc_t.data, enc_j.data)
    np.testing.assert_array_equal(tppm.PPM_DECODER(enc_t, M).data,
                                  jppm.PPM_DECODER(enc_j, M).data)
    # a tensor is taken like an array
    np.testing.assert_array_equal(
        tppm.PPM_DECODER(torch.from_numpy(enc_t.data), M).data,
        jppm.PPM_DECODER(enc_j, M).data)


def test_hdd_matches_jax_under_one_rng():
    on = (np.random.default_rng(4).random(N_SLOTS) < 0.2).astype(np.uint8)
    out_j = jppm.HDD(on, M, rng=np.random.default_rng(9))
    out_t = tppm.HDD(on, M, rng=np.random.default_rng(9))
    np.testing.assert_array_equal(out_t.data, out_j.data)
    assert (out_t.data.reshape(-1, M).sum(-1) == 1).all()
    np.random.seed(5)
    legacy_j = jppm.HDD(on, M).data
    np.random.seed(5)
    np.testing.assert_array_equal(tppm.HDD(on, M).data, legacy_j)


def _waveform(seed=0, sigma=0.15):
    """A noisy M-PPM voltage: one-hot slots held over sps samples."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, M, N_SYM)
    slots = np.zeros(N_SLOTS)
    slots[np.arange(N_SYM) * M + pos] = 1.0
    x = np.repeat(slots, SPS) + sigma * rng.normal(size=N_SLOTS * SPS)
    return x.astype(np.float32), pos


def test_sdd_matches_jax():
    x, _ = _waveform()
    want = jppm.SDD(JSignal(x), M).data
    np.testing.assert_array_equal(tppm.SDD(TSignal(x), M).data, want)
    np.testing.assert_array_equal(tppm.SDD(x, M).data, want)
    np.testing.assert_array_equal(tppm.SDD(torch.from_numpy(x), M).data, want)


def test_threshold_est_and_estimator_match_jax():
    stats = dict(mu0=0.02, mu1=1.01, s0=0.11, s1=0.16)
    ej, et = jppm.Eye(stats), TEye(stats)
    assert tppm.THRESHOLD_EST(et, M) == jppm.THRESHOLD_EST(ej, M)
    for decision in ("hard", "soft"):
        assert tppm.BER_analizer(
            "estimator", eye_obj=et, M=M, decision=decision) == pytest.approx(
                jppm.BER_analizer("estimator", eye_obj=ej, M=M,
                                  decision=decision), rel=1e-12)
    tx = _bits()
    rx = tx.copy()
    rx[::7] ^= 1
    assert tppm.BER_analizer("counter", Tx=tx, Rx=rx) == jppm.BER_analizer(
        "counter", Tx=tx, Rx=rx)


@pytest.mark.parametrize("decision", ["soft", "hard"])
def test_theory_ber_matches_jax(decision):
    mu1 = np.array([0.5, 1.0])
    np.testing.assert_allclose(
        tppm.theory_BER(mu1, 0.1, 0.12, M, decision),
        jppm.theory_BER(mu1, 0.1, 0.12, M, decision), rtol=1e-12)


@pytest.mark.parametrize("decision,threshold", [("soft", None), ("hard", 0.5),
                                                ("hard", None)])
def test_dsp_matches_jax(decision, threshold):
    """Decoded bits equal; with the blind threshold the two eye engines (the
    JAX host NumPy pipeline, the port's device twin) agree to 2e-4
    (tests/test_eye_device.py), far inside this eye's opening."""
    x, _ = _waveform(seed=3, sigma=0.08)
    np.random.seed(1)
    want = jppm.DSP(JSignal(x), M, decision=decision, threshold=threshold)
    np.random.seed(1)
    got = tppm.DSP(TSignal(x), M, decision=decision, threshold=threshold)
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("call,exc", [
    (lambda m: m.HDD(np.zeros(12), 6), ValueError),
    (lambda m: m.HDD(np.zeros(12), 8), ValueError),
    (lambda m: m.SDD(np.zeros(5), 8), ValueError),
    (lambda m: m.SDD("0101", 8), TypeError),
    (lambda m: m.THRESHOLD_EST(object(), 8), TypeError),
    (lambda m: m.DSP(np.zeros(16 * 8), 8, decision="nope"), ValueError),
    (lambda m: m.DSP(np.zeros(4), 8), ValueError),
    (lambda m: m.BER_analizer("counter", Tx=[1, 0]), KeyError),
    (lambda m: m.BER_analizer("estimator", eye_obj=None, M=8), KeyError),
    (lambda m: m.BER_analizer("guess"), ValueError),
    (lambda m: m.theory_BER(1.0, 0.1, 0.1, 8, "firm"), ValueError),
    (lambda m: m.PPM_ENCODER(3.5, 8), TypeError),
])
def test_host_validation_matches_jax(call, exc):
    for mod in (jppm, tppm):
        with pytest.raises(exc):
            call(mod)


def test_shim_exports_the_reference_namespace():
    import opticomlib_tpu.ppm as jshim
    # the JAX names, and the port's own names of the three decisions the
    # JAX names alias
    assert sorted(tppm_shim.__all__) == sorted(
        [*jshim.__all__, *(n[:-len("_jax")] for n in jshim.__all__
                           if n.endswith("_jax"))])
    assert tppm_shim.DSP is tppm.DSP


# ---------------------------------------------------------------------------
# LinkProgram.dsp_ppm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,seed", [(dict(), 0),
                                     (dict(P0=-18, include_thermal=True), 5),
                                     (dict(P0=-24, include_thermal=True), 5)])
def test_dsp_ppm_soft_matches_jax(kw, seed):
    """Equal error counts on the JAX program's draws, noiseless, lightly
    noisy and at a BER of tens of percent."""
    jprog, tprog = _progs(**kw)
    bits = _bits()
    dj = jprog.dsp_ppm(M, decision="soft", bits=bits, seed=seed)
    dt = tprog.dsp_ppm(M, decision="soft", bits=bits,
                       noise=_noise(jprog, seed))
    assert dt.n_errors == dj.n_errors and dt.ber == dj.ber
    assert dt.threshold is None and dt.eye is None
    assert dt.decision == "soft" and dt.M == M
    np.testing.assert_array_equal(dt.slots_tx.data, dj.slots_tx.data)
    if kw.get("P0") == -24:
        assert 0.0 < dt.ber < 0.6


@pytest.mark.parametrize("kw,seed", [(dict(), 0),
                                     (dict(P0=-20, include_thermal=True), 7),
                                     (dict(P0=-20, include_thermal=True), 9)])
def test_dsp_ppm_hard_matches_jax(kw, seed):
    """Equal error counts with the chain's draws and the HDD draw injected;
    threshold rel 1e-5, eye scalars rel 1e-4."""
    jprog, tprog = _progs(**kw)
    bits = _bits()
    dj = jprog.dsp_ppm(M, decision="hard", bits=bits, seed=seed)
    dt = tprog.dsp_ppm(M, decision="hard", bits=bits, seed=seed,
                       noise=_noise(jprog, seed))
    assert dt.n_errors == dj.n_errors
    assert dt.threshold == pytest.approx(dj.threshold, rel=1e-5)
    for k in ("mu0", "mu1", "s0", "s1", "t_opt", "er", "eye_h"):
        np.testing.assert_allclose(getattr(dt.eye, k), getattr(dj.eye, k),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert dt.eye.mu1 > dt.eye.mu0 and dt.eye.y is None
    if not kw:
        assert dt.n_errors == 0


def test_dsp_ppm_soft_matches_host_pipeline():
    """Without injected draws: the fused soft receiver equals the port's
    host SDD + DECODER on the same waveform, bit for bit."""
    _, tprog = _progs(P0=-18, include_thermal=True)
    bits = _bits()
    d = tprog.dsp_ppm(M, decision="soft", bits=bits, seed=5)
    res = tprog.run(bits=tppm.PPM_ENCODER(bits, M).data, seed=5)
    rx = tppm.DSP(TSignal(res.v), M, decision="soft")
    assert d.ber == tppm.BER_analizer("counter", Tx=bits, Rx=rx)


def test_dsp_ppm_hard_tracks_host_pipeline():
    """Without injected draws the HDD randomness differs (a seeded
    torch.Generator vs np.random): statistically consistent, abs 0.05 as
    tests/test_link_ppm.py::test_hard_noisy_tracks_host."""
    _, tprog = _progs(P0=-20, include_thermal=True)
    bits = _bits()
    d = tprog.dsp_ppm(M, decision="hard", bits=bits, seed=7)
    res = tprog.run(bits=tppm.PPM_ENCODER(bits, M).data, seed=7)
    np.random.seed(0)
    rx = tppm.DSP(TSignal(res.v), M, decision="hard")
    assert d.ber == pytest.approx(
        tppm.BER_analizer("counter", Tx=bits, Rx=rx), abs=0.05)


def test_dsp_ppm_reproducible_and_keyed_by_seed():
    _, tprog = _progs(P0=-20, include_thermal=True)
    bits = _bits()
    d1 = tprog.dsp_ppm(M, decision="hard", bits=bits, seed=9)
    d2 = tprog.dsp_ppm(M, decision="hard", bits=bits, seed=9)
    assert d1.n_errors == d2.n_errors and d1.threshold == d2.threshold
    u9 = tlink._hdd_uniform(9, N_SYM, M, None, tprog.device)
    assert torch.equal(u9, tlink._hdd_uniform(9, N_SYM, M, None, "cpu"))
    assert not torch.equal(u9, tlink._hdd_uniform(10, N_SYM, M, None,
                                                  "cpu"))
    assert u9.shape == (N_SYM, M) and 0 <= float(u9.min()) \
        and float(u9.max()) < 1


def test_dsp_ppm_default_bits_are_the_prbs():
    jprog, tprog = _progs()
    dj, dt = jprog.dsp_ppm(M, seed=0), tprog.dsp_ppm(M, seed=0)
    np.testing.assert_array_equal(dt.tx.data, dj.tx.data)
    assert dt.n_errors == dj.n_errors == 0


@pytest.mark.parametrize("args,kw", [((3,), {}), ((M,), dict(decision="nope")),
                                     ((M,), dict(bits=np.ones(7))),
                                     ((2 * N_SLOTS,), {})])
def test_dsp_ppm_validation_matches_jax(args, kw):
    """tests/test_link_ppm.py::test_validation, and slots that are not a
    multiple of M."""
    jprog, tprog = _progs()
    kw.setdefault("bits", _bits())
    for prog in (jprog, tprog):
        with pytest.raises(ValueError):
            prog.dsp_ppm(*args, **kw)
