"""Equal-accuracy calibration of config 2's split-step schemes, on
``opticomlib_tpu_torch`` (the twin of ``scripts/calibrate_equal_accuracy.py``).

The reference scheme (2nd-order frozen-operator step, phi_max = 0.01
adaptive) sets the output error to match; the port's higher-order schemes
reach it with fewer FFT pairs.  On config 2's fiber (50 km, NRZ at 0.02 W
peak, sps 64, 2^24 samples) this script measures, as the JAX script does:

1. TRUTH: o4 at h = 0.05 km (1000 steps), cross-checked against the
   local-error scheme at tol = 1e-5 (another discretization family; the
   cross-check is the float32 floor of the run);
2. REFERENCE ERROR: the reference scheme at phi_max = 0.01, relative L2
   error against the truth;
3. MATCH: the largest o4 step h and the largest local-error tol whose error
   is at most the reference error;
4. TIGHT: the largest phi_max and o4 h whose error is at most 8.0e-3.

A grid with no candidate at its target gives ``null``.  The fixed-step o4
loop is the JAX script's (``torch_calibration_common.o4_fixed``), so its
step and FFT-pair counts are the JAX ones.  The entries are merged into
``--out`` (default ``EQUAL_ACCURACY_CUDA.json`` at the repository root),
with the device they ran on.

Usage: python scripts/torch_calibrate_equal_accuracy.py [--n 24]
       [--device cuda|cpu] [--out PATH]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_calibration_common as common  # noqa: E402

N_BITS_LOG2 = 18
SPS = 64
R = 10e9
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3)
PHI_MAX = 0.01
PEAK_W = 0.02
TRUTH_H = 0.05
XCHECK_TOL = 1e-5
O4_GRID = (12.5, 10.0, 8.0, 6.25, 5.0, 4.0, 3.0, 2.5, 2.0, 1.5, 1.0)
LE_GRID = (3e-4, 1e-4, 3e-5, 1e-5)
# the tight target: ~2.1x below the reference default and above the float32
# floor the JAX script measured (its cross-check 3.0e-3, o4 plateauing near
# 7e-3); the card's floor is this run's cross-check
TIGHT = 8.0e-3
TIGHT_REF_GRID = (0.004, 0.002, 0.001, 0.0005, 0.00025)
TIGHT_O4_GRID = (1.25, 1.0, 0.8, 0.625, 0.5, 0.4, 0.3)


def main(argv=None) -> dict:
    import torch

    from opticomlib_tpu_torch.ops import ssfm

    args = common.parse_args(argv, __doc__, {"n": (
        N_BITS_LOG2 + 6, "log2 of the sample count (default 24); the bits "
        "are 2^(n - 6) at 64 samples a bit")})
    dev = args.device
    n_bits = 2 ** (args.n - 6)
    n = n_bits * SPS

    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, n_bits)
    A_np = (np.repeat(bits, SPS) * np.sqrt(PEAK_W)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n) * R * SPS
    phi_w = torch.as_tensor(ssfm.dispersion_phase(w, CFG["beta_2"], 0.0),
                            device=dev)
    a_km = ssfm.alpha_per_km(CFG["alpha"])
    A = torch.as_tensor(A_np, device=dev)
    L, gamma = CFG["length"], CFG["gamma"]
    maxP0 = float(np.max(A_np.real ** 2 + A_np.imag ** 2))

    def run_o4(h):
        (out, k), t = common.timed(dev, lambda: common.o4_fixed(
            A, phi_w, L, gamma, a_km, h))
        return out, t, 3 * k

    def run_ref(phi_max):
        h0 = min(phi_max / (gamma * maxP0), L)
        (out, steps), t = common.timed(dev, lambda: ssfm.ssfm_while_inside(
            A, phi_w, L, gamma, phi_max, h0, a_km, adaptive=True))
        return out, t, steps

    def run_le(tol, h0):
        (out, steps), t = common.timed(dev, lambda: (
            ssfm.ssfm_local_error_inside(A, phi_w, L, gamma, tol, h0, a_km)))
        return out, t, 3 * steps

    print(f"[calibrate] n = 2^{int(np.log2(n))} samples on {dev}",
          flush=True)
    truth, t_truth, _ = run_o4(TRUTH_H)
    print(f"[calibrate] truth (o4 h={TRUTH_H}): {t_truth:.2f} s", flush=True)
    xchk, t_x, x_pairs = run_le(XCHECK_TOL, h0=1.0)
    truth_xcheck = common.rel_err(xchk, truth)
    del xchk
    print(f"[calibrate] truth cross-check (local_error tol={XCHECK_TOL}): "
          f"{truth_xcheck:.3g} ({x_pairs} FFT-pairs, {t_x:.2f} s)",
          flush=True)

    ref_out, t_ref, ref_steps = run_ref(PHI_MAX)
    ref_error = common.rel_err(ref_out, truth)
    del ref_out
    print(f"[calibrate] reference scheme (phi_max={PHI_MAX}): "
          f"{ref_steps} steps, {t_ref:.2f} s, rel err {ref_error:.3g}",
          flush=True)

    def first_within(label, grid, run, key, target):
        """The first candidate of ``grid`` whose error is at most
        ``target``, as the JAX script's entry, or None."""
        for c in grid:
            out, t, pairs = run(c)
            e = common.rel_err(out, truth)
            del out
            print(f"[calibrate] {label} {key}={c}: {pairs} FFT-pairs, "
                  f"{t:.2f} s, rel err {e:.3g}", flush=True)
            if e <= target:
                return {key: c, "error": e, "fft_pairs": pairs,
                        "wall_s": round(t, 3)}
        return None

    o4_match = first_within("o4", O4_GRID, run_o4, "h", ref_error)
    le_match = first_within("local_error", LE_GRID,
                            lambda tol: run_le(tol, h0=5.0), "tol",
                            ref_error)
    tight_ref = first_within("TIGHT ref", TIGHT_REF_GRID, run_ref,
                             "phi_max", TIGHT)
    tight_o4 = first_within("TIGHT o4", TIGHT_O4_GRID, run_o4, "h", TIGHT)

    result = {
        "config": {**CFG, "phi_max": PHI_MAX, "sps": SPS, "R": R,
                   "peak_W": PEAK_W, "n_samples": n},
        "truth": {"scheme": "o4", "h": TRUTH_H,
                  "cross_check_scheme": "local_error tol=1e-5",
                  "cross_check_rel_err": truth_xcheck},
        "reference_scheme": {"phi_max": PHI_MAX, "n_steps": ref_steps,
                             # one fft+ifft pair per step
                             "fft_pairs": ref_steps,
                             "error": ref_error,
                             "wall_s": round(t_ref, 3)},
        "o4": o4_match,
        "local_error": le_match,
        "tight": {"target_error": TIGHT, "reference_scheme": tight_ref,
                  "o4": tight_o4},
        "method": "largest step/tol whose relative L2 output error vs an "
                  "o4 h=0.05 truth run is <= the reference scheme's "
                  "error at phi_max=0.01 (same waveform, same hardware)",
        "note": common.NOTE,
        "device": common.device_block(dev),
    }
    common.merge(args.out, result)
    print(f"[calibrate] wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
