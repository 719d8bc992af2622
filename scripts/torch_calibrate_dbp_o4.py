"""Config 4's DBP o4 step, on ``opticomlib_tpu_torch`` (the twin of
``scripts/calibrate_dbp_o4.py``): a self-consistent round trip against an
absolute target, cross-checked by an independent forward truth.

Config 4 is 20 x 80 km amplified spans (alpha 0.2 dB/km, beta2 -21
ps^2/km, gamma 1.3 /W/km, gain = the span loss), sps 16, NRZ at 0.005 W
peak.  Per-span DBP inverts the link, and ``||out - in|| / ||in||`` of the
noiseless 40-span round trip is the scheme's self-inversion residual (the
reference's own test oracle, devices_test.py:271-277).  As the JAX script,
this one

1. records the parity scheme's residual at phi_max = 0.05 as the capability
   gap (it does not invert the link: ~sqrt(2)), not as a target;
2. takes the largest o4 step of its grid whose round-trip residual meets
   the absolute target ``RT_TARGET`` = 1e-2;
3. records each candidate's forward error against the 20-span forward
   output of the local-error scheme at tol = 1e-5.

The fixed-step o4 spans are the JAX script's loop
(``torch_calibration_common.o4_fixed``).  Merges a ``config4`` entry into
``--out`` (default ``EQUAL_ACCURACY_CUDA.json`` at the repository root).

Usage: python scripts/torch_calibrate_dbp_o4.py [--n 20] [--device cuda|cpu]
       [--out PATH]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_calibration_common as common  # noqa: E402

f32 = np.float32
N_LOG2 = 20
SPS = 16
R = 10e9
N_SPANS = 20
SPAN_KM = 80.0
ALPHA, BETA2, GAMMA = 0.2, -21.0, 1.3
PHI_MAX = 0.05
PEAK_W = 0.005
RT_TARGET = 1e-2  # absolute round-trip residual target
TRUTH_TOL = 1e-5
O4_GRID = (20.0, 16.0, 10.0, 8.0, 5.0, 4.0, 2.5, 2.0, 1.0)


def main(argv=None) -> dict:
    import torch

    from opticomlib_tpu_torch.ops import ssfm

    args = common.parse_args(argv, __doc__, {"n": (
        N_LOG2, "log2 of the sample count (default 20)")})
    dev = args.device
    n = 2 ** args.n

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, n // SPS)
    A_np = (np.repeat(bits, SPS) * np.sqrt(PEAK_W)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n) * R * SPS
    phi_w = torch.as_tensor(ssfm.dispersion_phase(w, BETA2, 0.0),
                            device=dev)
    neg_phi_w = -phi_w
    a_km = ssfm.alpha_per_km(ALPHA)
    A0 = torch.as_tensor(A_np, device=dev)
    gain = f32(10 ** (ALPHA * SPAN_KM / 20))

    def chain(A, span, sgn):
        """``N_SPANS`` spans of ``span(A, phi_w, gamma, alpha) -> (A,
        steps)``: forward (``sgn`` +1: the span, then the gain) or DBP
        (-1: the gain undone, then the span with every sign flipped).
        Returns the field and the steps summed."""
        pw = phi_w if sgn > 0 else neg_phi_w
        total = 0
        for _ in range(N_SPANS):
            if sgn < 0:
                A = A / float(gain)
            A, k = span(A, pw, f32(sgn * GAMMA), f32(sgn * a_km))
            if sgn > 0:
                A = A * float(gain)
            total += k
        return A, total

    def parity_span(A, pw, g, al):
        with np.errstate(divide="ignore"):
            h0 = min(f32(PHI_MAX) / (f32(GAMMA) * ssfm.max_power(A)),
                     f32(SPAN_KM))
        return ssfm.ssfm_while_inside(A, pw, SPAN_KM, g, PHI_MAX, h0, al,
                                      adaptive=True)

    def o4_span(h):
        return lambda A, pw, g, al: common.o4_fixed(A, pw, SPAN_KM, g, al, h)

    def le_span(A, pw, g, al):
        return ssfm.ssfm_local_error_inside(A, pw, SPAN_KM, g, TRUTH_TOL,
                                            SPAN_KM / 20, al)

    def round_trip(span):
        """The 20 spans and their 20 DBP spans; the steps of all 40."""
        A, s1 = chain(A0, span, 1.0)
        A, s2 = chain(A, span, -1.0)
        return A, s1 + s2

    print(f"[dbp-cal] n = 2^{args.n} samples on {dev}", flush=True)
    (fwd_truth, _), t = common.timed(dev, lambda: chain(A0, le_span, 1.0))
    print(f"[dbp-cal] forward truth (local_error tol={TRUTH_TOL} x "
          f"{N_SPANS} spans): {t:.2f} s", flush=True)

    (out, n_par), t = common.timed(dev, lambda: round_trip(parity_span))
    e_par = common.rel_err(out, A0)
    print(f"[dbp-cal] parity (phi_max={PHI_MAX}): {n_par} steps "
          f"({n_par} fft-pairs), rt err {e_par:.4g} "
          f"{'(CANNOT invert at this setting)' if e_par > 0.5 else ''}, "
          f"{t:.2f} s", flush=True)

    match = None
    for h in O4_GRID:
        (out, nst), t_rt = common.timed(dev, lambda: round_trip(o4_span(h)))
        e = common.rel_err(out, A0)
        (fwd, _), t_fwd = common.timed(dev, lambda: chain(A0, o4_span(h),
                                                          1.0))
        e_fwd = common.rel_err(fwd, fwd_truth)
        del out, fwd
        pairs = 3 * nst
        print(f"[dbp-cal] o4 h={h}: {pairs} fft-pairs, rt err {e:.4g}, "
              f"fwd err vs local_error truth {e_fwd:.4g}, round trip "
              f"{t_rt:.2f} s, forward {t_fwd:.2f} s", flush=True)
        if e <= RT_TARGET:
            match = {"h": h, "rt_error": e, "fwd_error": e_fwd,
                     "fft_pairs": pairs}
            break

    entry = {
        "metric": "self-consistent DBP round trip vs ABSOLUTE target "
                  f"{RT_TARGET} (reference oracle "
                  "devices_test.py:271-277); fwd_error = forward chain "
                  "vs an independent local_error tol=1e-5 truth",
        "rt_target": RT_TARGET,
        "parity": {"phi_max": PHI_MAX, "rt_error": e_par,
                   "fft_pairs": n_par,
                   "note": "the parity scheme does NOT invert this link "
                           "at its bench settings (residual ~sqrt(2) = "
                           "decorrelated); recorded as the capability "
                           "gap, NOT used as a calibration target"},
        "o4": match,
        "n_samples": n,
        "device": common.device_block(dev),
    }
    common.merge(args.out, {"config4": entry})
    print(f"[dbp-cal] wrote config4 entry -> {args.out}", flush=True)
    return entry


if __name__ == "__main__":
    main()
