"""BER-level check of the matched o4 step, on ``opticomlib_tpu_torch`` (the
twin of ``scripts/ber_equal_accuracy.py``).

A launch-power sweep on a config-2-shaped link (PRBS15 bits, gaussian
pulses, MZM, 50 km NLSE fiber, EDFA with ASE, PD with thermal and shot
noise; ``build_link`` -> ``LinkProgram.dsp`` and ``run``), run twice a power
on the same noise (same seed: the link draws every noise from one generator
in stage order, and the fiber stage draws nothing, whatever its scheme):

* the reference scheme, phi_max = 0.01 adaptive, and
* o4 at the matched step read from ``--out`` (``o4.h``, written by
  ``torch_calibrate_equal_accuracy.py``).

For each power it decides every bit with each scheme's own threshold and
counts the bits the two decide differently, and records each scheme's
measured BER and eye Q = (mu1 - mu0) / (s1 + s0).  Merges ``ber_check``
into ``--out`` (default ``EQUAL_ACCURACY_CUDA.json`` at the repository
root).

Usage: python scripts/torch_ber_equal_accuracy.py [--bits 15] [--sps 64]
       [--device cuda|cpu] [--out PATH]
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_calibration_common as common  # noqa: E402

R = 10e9
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3)
PHI_MAX = 0.01
POWERS_DBM = [-9.0, -6.0, 2.0, 7.0, 12.0, 16.0]
SEED = 11
PRBS_ORDER = 15


def spec_for(P0: float, method: str, h_match: float):
    """Config 2's link at launch power ``P0`` [dBm], its fiber the
    reference scheme or o4 at ``h_match``."""
    from opticomlib_tpu_torch.link import EDFASpec, FiberSpec, LinkSpec
    fib = (FiberSpec(phi_max=PHI_MAX, **CFG) if method == "reference"
           else FiberSpec(method="o4", h=h_match, **CFG))
    return LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=P0,
                    pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                    stages=(fib, EDFASpec(G=10, NF=5)), pd_BW=0.75 * R)


def main(argv=None) -> dict:
    import torch

    from opticomlib_tpu_torch.link import build_link
    from opticomlib_tpu_torch.ops.prbs import prbs
    from opticomlib_tpu_torch.params import SimParams

    args = common.parse_args(argv, __doc__, {
        "bits": (15, "log2 of the bit count (default 15)"),
        "sps": (64, "samples a bit (default 64)")})
    dev = args.device
    n_bits, sps = 2 ** args.bits, args.sps

    with open(args.out) as f:
        matched = json.load(f).get("o4")
    if not matched:
        raise SystemExit(f"{args.out} holds no matched o4 step: run "
                         "scripts/torch_calibrate_equal_accuracy.py first")
    h_match = float(matched["h"])

    params = SimParams.create(sps=sps, R=R, _warn=False)
    bits = np.asarray(prbs(PRBS_ORDER, length=n_bits)[0], np.uint8)

    rows = []
    for P0 in POWERS_DBM:
        row = {"P0_dBm": P0}
        decided = {}
        for method in ("reference", "o4"):
            prog = build_link(spec_for(P0, method, h_match), n_bits,
                              params=params, device=dev)
            (d, r), t = common.timed(dev, lambda: (
                prog.dsp(bits=bits, seed=SEED, nslots=min(8192, n_bits)),
                prog.run(bits=bits, seed=SEED)))
            # float64 comparison, as NumPy compares the read-back slots
            decided[method] = r.slots.signal.real.double() > d.threshold
            q = ((d.eye.mu1 - d.eye.mu0)
                 / max(d.eye.s1 + d.eye.s0, 1e-30))
            row[method] = {
                "ber": d.ber, "n_errors": d.n_errors,
                "threshold": round(float(d.threshold), 6),
                "q": round(float(q), 3), "n_steps": list(d.n_steps),
                "wall_s": round(t, 3)}
        row["bit_disagreements"] = int(torch.count_nonzero(
            decided["reference"] != decided["o4"]))
        # binomial CI half-width on the BER at this n (2 sigma)
        p = max(row["reference"]["ber"], 1.0 / n_bits)
        row["ber_ci_2sigma"] = round(
            2 * np.sqrt(p * (1 - p) / n_bits), 8)
        print(f"[ber-eq] P0={P0:5.1f} dBm  "
              f"ref BER={row['reference']['ber']:.3e} "
              f"Q={row['reference']['q']:.2f}  "
              f"o4 BER={row['o4']['ber']:.3e} Q={row['o4']['q']:.2f}  "
              f"disagreements={row['bit_disagreements']}/{n_bits}",
              flush=True)
        rows.append(row)

    entry = {
        "n_bits": n_bits, "sps": sps, "seed": SEED,
        "o4_h": h_match, "reference_phi_max": PHI_MAX,
        "method": "same-noise (same seed) launch-power sweep; "
                  "cross-scheme bit-decision disagreements + measured "
                  "BER/Q per scheme",
        "rows": rows,
        "note": "wall_s: one dsp and one run of the scheme's link (not its "
                "build), host clock between two torch.cuda.synchronize() "
                "calls; the decisions are compared on the device",
        "device": common.device_block(dev),
    }
    common.merge(args.out, {"ber_check": entry})
    print(f"[ber-eq] wrote ber_check -> {args.out}", flush=True)
    return entry


if __name__ == "__main__":
    main()
