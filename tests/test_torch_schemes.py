"""The port's higher-order split-step schemes (opticomlib_tpu_torch.ops.ssfm:
4th-order fixed-step, self-tuning 4th-order and local-error) against the
JAX package's (opticomlib_tpu.ops.ssfm), on the pulse of
tests/test_ssfm_schemes.py (2048 samples at 640 GHz, 80 mW peak, 12 km of
alpha 0.2 dB/km, beta2 -21 ps^2/km, gamma 1.3 /W/km).

Both step controllers run in float32, so the attempted-step counts must be
equal (except where the tolerance sits below the float32 floor of the
error estimate, see the saturated case); the fields agree to relative
L2 <= 1e-4 (float32 FFT round-off over tens to hundreds of Strang
substeps).  The back-propagation sign flip
(negative gamma and alpha, as the DBP stage runs them) and a 2-pol field
are included.
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu.ops import ssfm as jssfm
from opticomlib_tpu_torch.ops import ssfm as tssfm

torch.set_num_threads(2)

CFG = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
L = 12.0
TOL = 1e-4


def _pulse(n=2048, fs=640e9, p0=0.08):
    t = np.arange(n) / fs
    A = np.sqrt(p0) * np.exp(-(((t - t.mean()) / 12e-12) ** 2) / 2)
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    return A.astype(np.complex64), jssfm.dispersion_phase(w, CFG["beta_2"],
                                                          0.0)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _planar(A):
    return np.ascontiguousarray(A.real), np.ascontiguousarray(A.imag)


def _field(two_pol):
    A, phi_w = _pulse()
    if two_pol:
        A = np.stack([A, 0.3 * A[::-1]]).astype(np.complex64)
    return A, phi_w


@pytest.mark.parametrize("h", [L / 8, 5.0])   # 5 km: 2 steps + a remainder
@pytest.mark.parametrize("sgn", [1.0, -1.0])
def test_o4_scan_matches_jax(h, sgn):
    A, phi_w = _pulse()
    if sgn < 0:
        phi_w = -phi_w
    a_km = sgn * jssfm.alpha_per_km(CFG["alpha"])
    g = sgn * CFG["gamma"]
    hs = jssfm.ssfm_step_schedule(L, h)
    re, im = jssfm._ssfm_scan_o4(*_planar(A), phi_w, hs, g, a_km)
    want = np.asarray(re) + 1j * np.asarray(im)
    got = tssfm.ssfm_o4_scan_inside(torch.from_numpy(A),
                                    torch.from_numpy(phi_w), hs, g, a_km)
    assert _rel(got.numpy(), want) <= TOL


SCHEMES = {"o4": (jssfm._ssfm_o4_auto_loop, tssfm.ssfm_o4_auto_inside),
           "local_error": (jssfm._ssfm_local_error_loop,
                           tssfm.ssfm_local_error_inside)}


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("tol,two_pol,sgn", [
    (1e-6, False, 1.0),
    (1e-4, False, 1.0),
    (1e-5, True, 1.0),
    (1e-5, False, -1.0),
])
def test_self_tuning_matches_jax(scheme, tol, two_pol, sgn):
    A, phi_w = _field(two_pol)
    if sgn < 0:
        phi_w = -phi_w
    a_km = sgn * jssfm.alpha_per_km(CFG["alpha"])
    g = sgn * CFG["gamma"]
    jfn, tfn = SCHEMES[scheme]
    re, im, steps_j = jfn(*_planar(A), phi_w, np.float32(L), np.float32(g),
                          np.float32(tol), np.float32(L / 10),
                          np.float32(a_km))
    want = np.asarray(re) + 1j * np.asarray(im)
    got, steps_t = tfn(torch.from_numpy(A), torch.from_numpy(phi_w), L, g,
                       tol, L / 10, a_km)
    assert steps_t == int(steps_j)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_saturated_tolerance_finishes_the_span(scheme):
    """tol = 1e-8 sits below the float32 floor of the error estimate: the
    saturation guard restores h and finishes fixed-step instead of
    collapsing h (tests/test_ssfm_schemes.py:133).  There delta is
    round-off noise: the two frameworks' FFTs round differently, and the
    cancellation in u_f - u_c magnifies that to ~3e-4 of delta at the
    first attempt already (with the same norm expression on both sides).
    In the o4 loop that moves where the guard trips: the JAX loop's
    non-improving rejections run 8 in a row and it trips at h = 0.3 km
    (51 attempts); the port's 8th attempt happens to improve on its 7th
    by more than 30 %, the count restarts, and it trips at 4.7 m (2578
    attempts).  The local-error loop trips at the same step (173 attempts
    each).  Both schemes finish the span at the float32 accuracy floor
    (relative error to a fine reference 9.4e-4 for the port's o4, 1.5e-4
    for the others)."""
    A, phi_w = _pulse()
    a_km = jssfm.alpha_per_km(CFG["alpha"])
    jfn, tfn = SCHEMES[scheme]
    re, im, steps_j = jfn(*_planar(A), phi_w, np.float32(L),
                          np.float32(CFG["gamma"]), np.float32(1e-8),
                          np.float32(L / 10), np.float32(a_km))
    want = np.asarray(re) + 1j * np.asarray(im)
    got, steps_t = tfn(torch.from_numpy(A), torch.from_numpy(phi_w), L,
                       CFG["gamma"], 1e-8, L / 10, a_km)
    assert steps_t < 400_000 and int(steps_j) < 400_000
    if scheme == "local_error":
        assert steps_t == int(steps_j)
        assert _rel(got.numpy(), want) <= TOL
    fine = jssfm.ssfm_scan_o4(A, 2 * np.pi * np.fft.fftfreq(A.size) * 640e9,
                              L, h=L / 512, **CFG)
    assert _rel(got.numpy(), fine) < 2e-3
    assert _rel(got.numpy(), want) < 2e-3
