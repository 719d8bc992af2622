"""The port's split-step solver (opticomlib_tpu_torch.ops.ssfm) against the
JAX package's (opticomlib_tpu.ops.ssfm) on config-2 physics (BASELINE.json
config 2: 50 km, alpha 0.2 dB/km, beta2 -21 ps^2/km, gamma 1.3 /W/km,
phi_max 0.01, 20 mW peak) at 2^14 samples.

Both step controllers run in float32, so the step counts must be equal;
the fields must agree to relative L2 <= 1e-4 (float32 FFT round-off over
tens of steps, measured ~1e-5).
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu.ops import ssfm as jssfm
from opticomlib_tpu_torch.ops import kernels
from opticomlib_tpu_torch.ops import ssfm as tssfm

torch.set_num_threads(2)

N, SPS, R = 2**14, 64, 10e9
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.01)
PEAK_W = 0.02


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def launch_field():
    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, N // SPS)
    A = (np.repeat(bits, SPS) * np.sqrt(PEAK_W)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(N) * R * SPS
    phi_w = jssfm.dispersion_phase(w, CFG["beta_2"], 0.0)
    return A, phi_w


def test_copied_helpers_agree():
    w = 2 * np.pi * np.fft.fftfreq(1024) * 640e9
    np.testing.assert_array_equal(tssfm.dispersion_phase(w, -21.0, 0.1),
                                  jssfm.dispersion_phase(w, -21.0, 0.1))
    assert tssfm.alpha_per_km(0.2) == jssfm.alpha_per_km(0.2)
    for length, h in [(50.0, 1.0), (50.0, 0.3), (1.0, 2.0)]:
        np.testing.assert_array_equal(tssfm.ssfm_step_schedule(length, h),
                                      jssfm.ssfm_step_schedule(length, h))
    assert (tssfm.adaptive_h0(0.01, 1.3, 0.02, 50.0)
            == jssfm.adaptive_h0(0.01, 1.3, 0.02, 50.0))


@pytest.mark.parametrize("adaptive", [True, False])
def test_while_loop_matches_jax(launch_field, adaptive):
    A, phi_w = launch_field
    a_km = jssfm.alpha_per_km(CFG["alpha"])
    maxP0 = float(np.max(np.abs(A) ** 2))
    h0 = (min(CFG["phi_max"] / (CFG["gamma"] * maxP0), CFG["length"])
          if adaptive else 0.7)
    re, im, steps_j = jssfm._ssfm_loop(
        A.real.copy(), A.imag.copy(), phi_w, CFG["length"], CFG["gamma"],
        CFG["phi_max"], h0, a_km, adaptive=adaptive)
    out_j = np.asarray(re) + 1j * np.asarray(im)

    kernels.reset_launches()
    out_t, steps_t = tssfm.ssfm_while_inside(
        torch.from_numpy(A), torch.from_numpy(phi_w), CFG["length"],
        CFG["gamma"], CFG["phi_max"], h0, a_km, adaptive=adaptive)
    assert steps_t == int(steps_j)
    assert _rel_l2(out_t.numpy(), out_j) <= 1e-4
    assert kernels.LAUNCHES["cmul"] == 0  # CPU tensors: plain versions


def test_scan_matches_jax(launch_field):
    A, phi_w = launch_field
    a_km = jssfm.alpha_per_km(CFG["alpha"])
    hs = jssfm.ssfm_step_schedule(CFG["length"], 0.7)  # 71 steps + remainder
    re, im = jssfm._ssfm_scan(A.real.copy(), A.imag.copy(), phi_w, hs,
                              CFG["gamma"], a_km)
    out_j = np.asarray(re) + 1j * np.asarray(im)
    out_t = tssfm.ssfm_scan_inside(torch.from_numpy(A),
                                   torch.from_numpy(phi_w), hs,
                                   CFG["gamma"], a_km)
    assert _rel_l2(out_t.numpy(), out_j) <= 1e-4


def test_two_polarizations_propagate_independently(launch_field):
    """A (2, n) field: each row equals its own 1-pol propagation (the
    spectral factor broadcasts over rows)."""
    A, phi_w = launch_field
    a_km = jssfm.alpha_per_km(CFG["alpha"])
    A2 = torch.from_numpy(np.stack([A, 0.5 * A[::-1].copy()]))
    hs = np.full(5, 0.5, np.float32)
    out2 = tssfm.ssfm_scan_inside(A2, torch.from_numpy(phi_w), hs,
                                  CFG["gamma"], a_km)
    for r in range(2):
        out1 = tssfm.ssfm_scan_inside(A2[r].clone(), torch.from_numpy(phi_w),
                                      hs, CFG["gamma"], a_km)
        assert _rel_l2(out2[r].numpy(), out1.numpy()) <= 1e-6


@pytest.mark.parametrize("fused", [False, True])
def test_step_counts_and_fused_loop(launch_field, monkeypatch, fused):
    """``STEP_COUNTS`` counts each step of the adaptive loop by its path.
    The CPU takes the composed step; with the fused kernels' condition
    forced true, the fused loop (the plain versions of ``spectral_phase``
    and ``cmul_max`` around an ``ifft`` with ``norm="forward"``) takes the
    composed loop's steps, holds to the JAX package as the composed loop
    does, and launches nothing."""
    A, phi_w = launch_field
    a_km = jssfm.alpha_per_km(CFG["alpha"])
    maxP0 = float(np.max(np.abs(A) ** 2))
    h0 = min(CFG["phi_max"] / (CFG["gamma"] * maxP0), CFG["length"])
    re, im, steps_j = jssfm._ssfm_loop(
        A.real.copy(), A.imag.copy(), phi_w, CFG["length"], CFG["gamma"],
        CFG["phi_max"], h0, a_km, adaptive=True)
    args = (torch.from_numpy(phi_w), CFG["length"], CFG["gamma"],
            CFG["phi_max"], h0, a_km)
    composed, steps_c = tssfm.ssfm_while_inside(torch.from_numpy(A), *args,
                                                adaptive=True)
    monkeypatch.setattr(tssfm, "STEP_COUNTS", dict(fused=0, composed=0))
    if fused:
        monkeypatch.setattr(tssfm, "_fuses", lambda A: True)
    kernels.reset_launches()
    out, steps = tssfm.ssfm_while_inside(torch.from_numpy(A), *args,
                                         adaptive=True)
    assert steps == steps_c == int(steps_j)
    assert tssfm.STEP_COUNTS == dict(fused=steps if fused else 0,
                                     composed=0 if fused else steps)
    # the CPU's FFT scales inside the transform, so only the card's fused
    # loop is bit-equal (tests/test_torch_cuda.py); here the two differ by
    # float32 FFT round-off over the steps
    assert _rel_l2(out.numpy(), composed.numpy()) <= 1e-4
    assert _rel_l2(out.numpy(), np.asarray(re) + 1j * np.asarray(im)) <= 1e-4
    assert not any(kernels.LAUNCHES.values())
    # a hooked linear step never fuses
    monkeypatch.setattr(tssfm, "STEP_COUNTS", dict(fused=0, composed=0))
    _, steps_l = tssfm.ssfm_while_inside(
        torch.from_numpy(A), None, *args[1:], adaptive=True,
        linear_step=lambda B, h: torch.fft.ifft(kernels.cmul(
            torch.fft.fft(B), tssfm._lin_factor(args[0], np.float32(a_km),
                                                h))))
    assert tssfm.STEP_COUNTS == dict(fused=0, composed=steps_l)


@pytest.mark.parametrize("fused", [False, True])
def test_fiber_span_says_whether_the_step_fused(monkeypatch, fused):
    """The link's ``fiber`` span carries ``fused``: True where the adaptive
    loop took the fused step (here forced on the CPU), False where it took
    the composed one; the steps and the answers do not change."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.params import SimParams
    from opticomlib_tpu_torch.utils import profiling
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        stages=(link.FiberSpec(length=50.0, alpha=0.2, beta_2=-21.0,
                               gamma=1.3),))
    prog = link.build_link(spec, 2**8, SimParams.create(sps=64, R=R,
                                                        _warn=False),
                           device="cpu")
    bits = np.random.default_rng(3).integers(0, 2, 2**8).astype(np.uint8)
    plain = prog.dsp(bits=bits, seed=1)
    if fused:
        monkeypatch.setattr(tssfm, "_fuses", lambda A: True)
    monkeypatch.setattr(tssfm, "STEP_COUNTS", dict(fused=0, composed=0))
    profiling.record(True)
    try:
        res = prog.dsp(bits=bits, seed=1)
        recs = profiling.drain()
    finally:
        profiling.record(False)
    (fib,) = [r for r in recs if r["name"] == "fiber"]
    assert fib["attrs"]["fused"] is fused
    assert fib["attrs"]["steps"] == res.n_steps[0] == plain.n_steps[0] > 10
    assert tssfm.STEP_COUNTS["fused" if fused else "composed"] == \
        res.n_steps[0]
    assert res.n_errors == plain.n_errors


@pytest.mark.parametrize("h_max", [None, 0.3])
def test_step_rule_on_arrays_equals_scalars(h_max):
    """The phi_max-adaptive step rule (``_first_step``, ``_phi_step``,
    ``_next_step``) on a float32 array of one ``max|A|^2`` a channel, with
    a live mask (the sharded link's per-channel loop), gives each channel
    the step sizes and count it gives that channel's scalars (the
    single-channel loop ``ssfm_while_inside``): a dark channel (one step),
    a NaN power (the loop ends), peaks that vary step to step."""
    f32 = np.float32
    L, g, pm = f32(50.0), f32(1.3), f32(0.01)
    powers = np.random.default_rng(5).uniform(
        1e-3, 0.05, (5, 20_000)).astype(f32)
    powers[0] = 0.0
    powers[1, 7] = np.nan
    powers[2] *= f32(40.0)

    def rule(p, z):
        return tssfm._next_step(tssfm._phi_step(pm, g, p), L, z, h_max)

    def scalar(p):
        z, h, hs = f32(0), tssfm._first_step(pm, g, p[0], L), []
        while z < L:
            z = z + h
            hs.append(h)
            h = rule(p[len(hs)], z)
        return hs

    z = np.zeros(len(powers), f32)
    h = tssfm._first_step(pm, g, powers[:, 0], L)
    steps, hs = np.zeros(len(powers), np.int64), [[] for _ in powers]
    with np.errstate(divide="ignore"):
        while (z < L).any():
            live = np.flatnonzero(z < L)
            z[live] = z[live] + h[live]
            for c in live:
                hs[c].append(h[c])
            steps[live] += 1
            h = rule(powers[np.arange(len(powers)), steps], z)
            assert h.dtype == f32
        want = [scalar(p) for p in powers]
    for c in range(len(powers)):
        assert all(type(x) is f32 for x in want[c])
        assert np.array(hs[c], f32).tobytes() == np.array(want[c],
                                                          f32).tobytes()
    assert steps[0] == 1 and steps[1] == 8 and steps[2] > steps[3] > 10


# ----------------------------------------------------------------------
# the fixed-step o4 scan: the card's chain of Strang substeps
# ----------------------------------------------------------------------
O4_HS = np.asarray([15.0, 15.0, 15.0, 5.0], np.float32)  # off-schedule last


def _o4_field(launch_field, two_pol):
    A, phi_w = launch_field
    if two_pol:
        A = np.stack([A, 0.5 * A[::-1]]).astype(np.complex64)
    return torch.from_numpy(A), torch.from_numpy(phi_w)


def _pencil_like(B, E):
    return torch.fft.ifft(kernels.cmul(torch.fft.fft(B, dim=-1), E), dim=-1)


@pytest.mark.parametrize("case", ["cpu", "spectral", "strided", "chain"])
@pytest.mark.parametrize("two_pol", [False, True])
def test_o4_scan_dispatch_counts_steps_by_path(launch_field, monkeypatch,
                                               case, two_pol):
    """``ssfm_o4_scan_inside`` takes the chain only where ``_fuses(A)``
    holds and no ``spectral`` hook is given, and counts each step in
    ``O4_COUNTS`` by its path.  Here the card's device check is made true
    (``Tensor.is_cuda`` patched; the kernels' wrappers still take their
    plain versions): a contiguous complex64 field then takes the chain,
    which leaves its input alone, launches nothing and ends near the
    composed scan (the CPU's inverse FFT scales inside the transform, so
    only the card's chain is bit-equal, tests/test_torch_cuda.py); a
    ``spectral`` hook and a non-contiguous field compose.  Unpatched, the
    CPU composes."""
    A, phi_w = _o4_field(launch_field, two_pol)
    a_km = tssfm.alpha_per_km(CFG["alpha"])
    composed = tssfm.ssfm_o4_scan_inside(A, phi_w, O4_HS, CFG["gamma"], a_km)
    monkeypatch.setattr(tssfm, "O4_COUNTS", dict(fused=0, composed=0))
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda self: True))
    spectral = _pencil_like if case == "spectral" else None
    if case == "strided":  # the composed steps are spied on: the kicks
        # refuse a non-contiguous field
        A = torch.stack([A, A], dim=-1)[..., 0]
        assert not A.is_contiguous()
        monkeypatch.setattr(tssfm, "_o4_step", lambda A, *a, **k: A)
    A0 = A.clone()
    kernels.reset_launches()
    out = tssfm.ssfm_o4_scan_inside(A, phi_w, O4_HS, CFG["gamma"], a_km,
                                    spectral=spectral)
    n = len(O4_HS)
    assert tssfm.O4_COUNTS == (dict(fused=n, composed=0) if case == "chain"
                               else dict(fused=0, composed=n))
    assert torch.equal(A, A0) and not any(kernels.LAUNCHES.values())
    if case != "strided":
        assert _rel_l2(out.numpy(), composed.numpy()) <= 1e-5


@pytest.mark.parametrize("n", [N, N + 3])
@pytest.mark.parametrize("sgn", [1.0, -1.0])
def test_o4_chain_matches_jax(launch_field, monkeypatch, n, sgn):
    """The chain (forced as above) against the JAX package's fixed-step o4
    at a power-of-two length and another one, forward and with the DBP's
    sign flip (negative gamma, alpha and phase): the steps the JAX schedule
    takes, and the fields within the scan's parity tolerance (relative L2
    <= 1e-4, tests/test_torch_schemes.py)."""
    A = launch_field[0]
    A = np.concatenate([A, A[:n - N]]) if n > N else A
    w = 2 * np.pi * np.fft.fftfreq(n) * R * SPS
    cfg = dict(alpha=sgn * CFG["alpha"], beta_2=sgn * CFG["beta_2"],
               gamma=sgn * CFG["gamma"])
    want = jssfm.ssfm_scan_o4(A, w, 50.0, h=15.0, **cfg)
    monkeypatch.setattr(tssfm, "O4_COUNTS", dict(fused=0, composed=0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    got, steps = tssfm.ssfm_scan_o4(torch.from_numpy(A), w, 50.0, h=15.0,
                                    **cfg)
    assert steps == len(jssfm.ssfm_step_schedule(50.0, 15.0)) == 4
    assert tssfm.O4_COUNTS == dict(fused=steps, composed=0)
    assert _rel_l2(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("fused", [False, True])
def test_fiber_span_says_whether_the_o4_scan_fused(monkeypatch, fused):
    """The ``fiber`` spans of a fixed-step o4 fiber and its DBP carry
    ``fused``: True where the scan took the chain (forced here), False
    where it composed; steps and answers unchanged."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.params import SimParams
    from opticomlib_tpu_torch.utils import profiling
    span = dict(length=40.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                method="o4", h=10.0)
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=10.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        stages=(link.FiberSpec(**span), link.EDFASpec(G=8),
                link.DBPSpec(undo_gain_dB=8, **span)))
    prog = link.build_link(spec, 2**8, SimParams.create(sps=16, R=R,
                                                        _warn=False),
                           device="cpu")
    bits = np.random.default_rng(4).integers(0, 2, 2**8).astype(np.uint8)
    plain = prog.dsp(bits=bits, seed=1)
    if fused:
        monkeypatch.setattr(tssfm, "_fuses", lambda A: True)
    monkeypatch.setattr(tssfm, "O4_COUNTS", dict(fused=0, composed=0))
    profiling.record(True)
    try:
        res = prog.dsp(bits=bits, seed=1)
        recs = profiling.drain()
    finally:
        profiling.record(False)
    fibs = [r for r in recs if r["name"] == "fiber"]
    assert [r["attrs"]["kind"] for r in fibs] == ["fiber", "dbp"]
    assert all(r["attrs"]["fused"] is fused for r in fibs)
    assert res.n_steps == plain.n_steps == (4, 4)
    assert tssfm.O4_COUNTS["fused" if fused else "composed"] == 8
    assert res.n_errors == plain.n_errors
