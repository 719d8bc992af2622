"""The benchmark CLI of ``opticomlib_tpu_torch`` on one NVIDIA card: the
twin of ``bench.py``, with its ten cells, physics, seeds, sizes, repetitions
and output.

    python bench_cuda.py                  # cells 1-4, one JSON line
    python bench_cuda.py --all            # all ten, also BENCH_ALL_CUDA.json
    python bench_cuda.py --device cpu --small --all --out /tmp/b.json

Prints ONE JSON line on standard output:
  {"metric": "ssfm_2e24_ook_throughput", "value": N, "unit": ...,
   "vs_baseline": N, "detail": {...}}

* ``metric/value``: split-step throughput on the 2^24-sample OOK field
  (50 km, alpha 0.2 dB/km, beta2 -21 ps^2/km, gamma 1.3 /W/km, phi_max 0.01
  adaptive, 20 mW NRZ peak: 99 steps of two FFTs each), through the public
  complex64 loop ``ops.ssfm.ssfm_while_inside``;
* ``detail.equal_accuracy``: the 4th-order scheme at the step calibrated to
  the reference scheme's error, and the tight-target rows, with the steps
  the card's own calibration chose (``EQUAL_ACCURACY_CUDA.json``);
* ``detail.full_chain_samples_per_s``: BASELINE config 2 through the fused
  link (``LinkProgram.jitted``: bits -> DAC -> MZM -> 50 km fiber -> EDFA ->
  PD -> LPF -> slot samples); ``detail.b2b_chain_samples_per_s``: config 1,
  back to back.

``--all`` adds configs 3 (8-PPM, ``dsp_ppm``), 2 receiver-complete
(``dsp``), 4 (20 x 80 km with per-span DBP at 2^20 samples, the adaptive
reference scheme and the calibrated 4th-order one), 5 (16 WDM channels of
2^22 samples through ``dsp_wdm``, and one channel of 2^26 through
``jitted``) and writes the ten rows to ``--out`` (default
``BENCH_ALL_CUDA.json`` beside this script; never ``BENCH_ALL.json``, the
JAX package's record).

Timing is ``bench.py``'s: one warm-up call (the kernels build there), then
the best of 3 (cells 1-2) or 2 (the rest) timed calls, each ended by
``torch.cuda.synchronize()``.  Each cell also gives every timed wall
(``walls_s``) and its peak device memory (``peak_mem_gib``,
``torch.cuda.max_memory_allocated`` after a reset; null on the CPU).
``detail.device`` names the card and its power limit (``nvidia-smi``).

``vs_baseline`` and each row's ``vs_reference_cpu`` divide by the NumPy
reference FIBER's throughput on a CPU (``BASELINE_MEASURED.json``); that
denominator is not a GPU number.

The cells run on the card unless ``--device cpu`` is given; without a card
the script exits non-zero.  ``--small`` runs every cell at 2^12-2^16
samples (:data:`SMALL`).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from opticomlib_tpu_torch.link import (EDFASpec, FiberSpec, LinkSpec,
                                       build_link)
from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.ops.prbs import prbs
from opticomlib_tpu_torch.params import SimParams, check_device

ROOT = os.path.dirname(os.path.abspath(__file__))

f32 = np.float32

N_BITS = 2**18
SPS = 64
R = 10e9
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.01)
PEAK_W = 0.02
CAL_PATH = os.path.join(ROOT, "EQUAL_ACCURACY_CUDA.json")
BASELINE_PATH = os.path.join(ROOT, "BASELINE_MEASURED.json")
DEFAULT_OUT = os.path.join(ROOT, "BENCH_ALL_CUDA.json")
BASELINE_NOTE = ("the denominator is the NumPy reference FIBER on a CPU "
                 "(BASELINE_MEASURED.json), not a GPU number")

#: ``--small``: each cell's size arguments, 2^12-2^16 samples (config 4
#: with 2 + 2 spans, config 5 with 2 channels)
SMALL = {
    "ssfm_headline": dict(n_bits=2**8, sps=64),
    "ssfm_equal_accuracy": dict(n_bits=2**6, sps=64),
    "full_chain": dict(n_bits=2**8, sps=64),
    "b2b_chain": dict(n_bits=2**8, sps=64),
    "ppm": dict(n_sym=2**8, sps=32),
    "fused_dsp": dict(n_bits=2**8, sps=64),
    "dbp": dict(n_spans=2, n=2**12),
    "dbp_o4": dict(n_spans=2, n=2**12),
    "wdm_batch": dict(n_ch=2, n_bits=2**10),
    "wdm_shard": dict(n_bits=2**10),
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(fn, dev: torch.device, reps: int = 3):
    """``bench.py``'s rule: one warm-up call of ``fn``, then ``reps`` timed
    calls, each from a synchronised device to the device synchronised after
    it.  Returns the best wall and every wall [s]."""
    fn()
    _sync(dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    return min(walls), walls


class _Peak:
    """Peak device memory of a cell: the allocator's peak is reset on entry
    and read as ``gib`` on exit (None on the CPU)."""

    def __init__(self, dev: torch.device):
        self.dev, self.gib = dev, None

    def __enter__(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self.gib = torch.cuda.max_memory_allocated(self.dev) / 2**30
        return False


def _measured(detail: dict, walls, peak: _Peak) -> dict:
    return {**detail, "walls_s": walls, "peak_mem_gib": peak.gib}


def _nrz_field(n_bits: int, sps: int, peak_w: float, seed: int):
    """``bench.py``'s launch field: random bits from ``seed``, NRZ at
    ``peak_w`` W, complex64 on the host."""
    bits = np.random.default_rng(seed).integers(0, 2, n_bits)
    return (np.repeat(bits, sps) * np.sqrt(peak_w)).astype(np.complex64)


def _phi_w(n: int, sps: int, beta_2: float, dev) -> torch.Tensor:
    w = 2 * np.pi * np.fft.fftfreq(n) * R * sps
    return torch.as_tensor(ssfm.dispersion_phase(w, beta_2, 0.0), device=dev)


def _load_cal(cal_path):
    if not os.path.exists(cal_path):
        return None
    with open(cal_path) as f:
        return json.load(f)


def bench_ssfm_headline(n_bits=N_BITS, sps=SPS, device="cuda"):
    """Split-step throughput alone at 2^24 samples (the headline): the
    phi_max-adaptive reference scheme over config 2's 50 km."""
    dev = check_device(device)
    n = n_bits * sps
    with _Peak(dev) as peak:
        A_np = _nrz_field(n_bits, sps, PEAK_W, 42)
        phi_w = _phi_w(n, sps, CFG["beta_2"], dev)
        a_km = ssfm.alpha_per_km(CFG["alpha"])
        A = torch.as_tensor(A_np, device=dev)
        maxP0 = float(np.max(A_np.real**2 + A_np.imag**2))
        h0 = min(CFG["phi_max"] / (CFG["gamma"] * maxP0), CFG["length"])
        box = {}

        def run():
            _, box["n"] = ssfm.ssfm_while_inside(
                A, phi_w, CFG["length"], CFG["gamma"], CFG["phi_max"], h0,
                a_km, adaptive=True)

        best, walls = _time(run, dev)
    return n / best, _measured({"n_steps": box["n"],
                                "wall_s": round(best, 3)}, walls, peak)


def bench_ssfm_equal_accuracy(n_bits=N_BITS, sps=SPS, cal_path=CAL_PATH,
                              device="cuda"):
    """The equal-accuracy rows: the 4th-order scheme at the largest step
    whose error matches the reference scheme's at phi_max 0.01, and, at
    the tight target, both schemes at their matched settings, read from the
    calibration file ``cal_path`` (the card's ``EQUAL_ACCURACY_CUDA.json``
    by default).  Without it the o4 step is 2.0 km and no tight row is
    timed.  Returns (samples/s at the default error, detail)."""
    dev = check_device(device)
    n = n_bits * sps
    cal = _load_cal(cal_path)
    h_match = 2.0   # conservative default if uncalibrated
    if cal and cal.get("o4"):
        h_match = float(cal["o4"]["h"])
    with _Peak(dev) as peak:
        A_np = _nrz_field(n_bits, sps, PEAK_W, 42)
        phi_w = _phi_w(n, sps, CFG["beta_2"], dev)
        a_km = ssfm.alpha_per_km(CFG["alpha"])
        A = torch.as_tensor(A_np, device=dev)
        maxP0 = float(np.max(A_np.real**2 + A_np.imag**2))

        def time_o4(h):
            hs = ssfm.ssfm_step_schedule(CFG["length"], h)
            best, walls = _time(lambda: ssfm.ssfm_o4_scan_inside(
                A, phi_w, hs, CFG["gamma"], a_km), dev)
            return best, walls, 3 * len(hs)

        def time_ref(phi_max):
            h0 = min(phi_max / (CFG["gamma"] * maxP0), CFG["length"])
            box = {}

            def run():
                _, box["n"] = ssfm.ssfm_while_inside(
                    A, phi_w, CFG["length"], CFG["gamma"], phi_max, h0, a_km,
                    adaptive=True)

            best, walls = _time(run, dev)
            return best, walls, box["n"]

        best, walls, pairs = time_o4(h_match)
        detail = {"scheme": "o4", "h_km": h_match, "fft_pairs": pairs,
                  "wall_s": round(best, 3)}
        if cal:
            detail["matched_error"] = cal.get("o4", {}).get("error")
            detail["reference_scheme_error"] = \
                cal.get("reference_scheme", {}).get("error")
            detail["calibration"] = cal.get("method")
            tight = cal.get("tight") or {}
            if tight.get("reference_scheme") and tight.get("o4"):
                t_ref, w_ref, ref_pairs = time_ref(
                    float(tight["reference_scheme"]["phi_max"]))
                t_o4, w_o4, o4_pairs = time_o4(float(tight["o4"]["h"]))
                detail["tight"] = {
                    "target_error": tight["target_error"],
                    "reference_scheme": {
                        "phi_max": tight["reference_scheme"]["phi_max"],
                        "error": tight["reference_scheme"]["error"],
                        "fft_pairs": ref_pairs,
                        "samples_per_s": round(n / t_ref, 1),
                        "wall_s": round(t_ref, 3), "walls_s": w_ref},
                    "o4": {"h_km": tight["o4"]["h"],
                           "error": tight["o4"]["error"],
                           "fft_pairs": o4_pairs,
                           "samples_per_s": round(n / t_o4, 1),
                           "wall_s": round(t_o4, 3), "walls_s": w_o4},
                    "speedup_at_equal_accuracy": round(t_ref / t_o4, 2),
                }
    return n / best, _measured(detail, walls, peak)


def _build_ook_link(stages, n_bits, sps, device):
    """P0 = 16 dBm with 3 dB MZM loss: about 20 mW peak launch, the
    headline's ``PEAK_W``, so the step counts compare."""
    params = SimParams.create(sps=sps, R=R, _warn=False)
    spec = LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
                    pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                    stages=stages, pd_BW=0.75 * R)
    return build_link(spec, n_bits=n_bits, params=params, device=device)


def _jitted_cell(stages, n_bits, sps, bits_seed, seed, device):
    """One ``LinkProgram.jitted`` call on random bits, best of 2:
    (samples/s, best, walls, peak)."""
    dev = check_device(device)
    with _Peak(dev) as peak:
        prog = _build_ook_link(stages, n_bits=n_bits, sps=sps, device=dev)
        bits = torch.as_tensor(np.random.default_rng(bits_seed).integers(
            0, 2, n_bits).astype(np.float32), device=dev)
        best, walls = _time(lambda: prog.jitted(bits, seed), dev, reps=2)
    return n_bits * sps / best, best, walls, peak


def bench_full_chain(n_bits=N_BITS, sps=SPS, device="cuda"):
    """BASELINE config 2 through the fused link (bits -> RX slots)."""
    rate, best, walls, peak = _jitted_cell(
        (FiberSpec(**CFG), EDFASpec(G=10, NF=5)), n_bits, sps, 1, 7, device)
    return rate, _measured({"wall_s": round(best, 3)}, walls, peak)


def bench_b2b_chain(n_bits=N_BITS, sps=SPS, device="cuda"):
    """BASELINE config 1: the chain back to back (no fiber)."""
    rate, best, walls, peak = _jitted_cell((), n_bits, sps, 2, 8, device)
    return rate, _measured({"wall_s": round(best, 3)}, walls, peak)


def bench_ppm(M=8, n_sym=2**15, sps=32, device="cuda"):
    """BASELINE config 3: 8-PPM through 20 km, receiver-complete
    (``LinkProgram.dsp_ppm``, soft decision; scalars read back)."""
    dev = check_device(device)
    k = int(np.log2(M))
    n_slots = n_sym * M
    with _Peak(dev) as peak:
        bits, _ = prbs(15, length=n_sym * k)
        prog = _build_ook_link(
            (FiberSpec(length=20, alpha=0.2, beta_2=-21.0, gamma=1.3),),
            n_bits=n_slots, sps=sps, device=dev)
        box = {}

        def run():
            box["d"] = prog.dsp_ppm(M, decision="soft", bits=bits, seed=3)

        best, walls = _time(run, dev, reps=2)
    return n_slots * sps / best, _measured(
        {"M": M, "ber": box["d"].ber, "wall_s": round(best, 3)}, walls, peak)


def bench_fused_dsp(n_bits=N_BITS, sps=SPS, device="cuda"):
    """Config 2 receiver-complete: chain, eye, threshold, slicer and BER
    (``LinkProgram.dsp``)."""
    dev = check_device(device)
    with _Peak(dev) as peak:
        prog = _build_ook_link((FiberSpec(**CFG), EDFASpec(G=10, NF=5)),
                               n_bits=n_bits, sps=sps, device=dev)
        bits, _ = prbs(15, length=n_bits)
        box = {}

        def run():
            box["d"] = prog.dsp(bits=bits, seed=3)

        best, walls = _time(run, dev, reps=2)
    return n_bits * sps / best, _measured(
        {"ber": box["d"].ber, "wall_s": round(best, 3)}, walls, peak)


def _config4(n, sps, span_km, dev):
    """Config 4's launch field, spectral phase, loss and span gain."""
    A0 = torch.as_tensor(_nrz_field(n // sps, sps, 0.005, 4), device=dev)
    phi_w = _phi_w(n, sps, -21.0, dev)
    return A0, phi_w, ssfm.alpha_per_km(0.2), f32(10 ** (0.2 * span_km / 20))


def bench_dbp(n_spans=20, span_km=80.0, n=2**20, sps=16, device="cuda"):
    """BASELINE config 4: 20 x 80 km spans, each followed by a transparent
    gain, then 20 spans of per-span DBP (the gain undone first), every span
    the phi_max 0.05 adaptive reference scheme from the span's own
    float32 max|A|^2.  One span is one ``ssfm_while_inside`` call, and the
    loop reads max|A|^2 back once a step."""
    dev = check_device(device)
    g, phi_max = 1.3, 0.05
    with _Peak(dev) as peak:
        A0, phi_w, a_km, gain = _config4(n, sps, span_km, dev)
        neg_phi_w = -phi_w

        def span(A, sgn):
            if sgn < 0:
                A = A / float(gain)  # undo the span gain before DBP
            with np.errstate(divide="ignore"):
                h0 = min(f32(phi_max) / (f32(g) * ssfm.max_power(A)),
                         f32(span_km))
            A, s = ssfm.ssfm_while_inside(
                A, phi_w if sgn > 0 else neg_phi_w, span_km, f32(sgn * g),
                phi_max, h0, f32(sgn * a_km), adaptive=True)
            if sgn > 0:
                A = A * float(gain)  # transparent EDFA
            return A, s

        box = {}

        def run():
            A, total = A0, 0
            for sgn in (1.0, -1.0):
                for _ in range(n_spans):
                    A, s = span(A, sgn)
                    total += s
            box["n"] = total

        best, walls = _time(run, dev, reps=2)
    rate = n / best
    return rate, _measured({
        "n_samples": n, "total_steps": box["n"],
        "sample_steps_per_s": round(rate * box["n"], 1),
        "wall_s": round(best, 3)}, walls, peak)


def bench_dbp_o4(n_spans=20, span_km=80.0, n=2**20, sps=16,
                 cal_path=CAL_PATH, device="cuda"):
    """Config 4 with the 4th-order scheme, the capability row: the same
    chain, each span a fixed-step Yoshida composition at the step
    calibrated to the absolute round-trip target
    (``cal_path["config4"]``, the card's ``EQUAL_ACCURACY_CUDA.json`` by
    default).  The parity scheme does not invert this link at its bench
    settings (residual ~sqrt(2)), so no speedup against it is claimed.
    Returns None if uncalibrated."""
    dev = check_device(device)
    cal = (_load_cal(cal_path) or {}).get("config4") or {}
    if not cal.get("o4"):
        return None
    h = float(cal["o4"]["h"])
    g = 1.3
    hs = ssfm.ssfm_step_schedule(span_km, h)
    with _Peak(dev) as peak:
        A0, phi_w, a_km, gain = _config4(n, sps, span_km, dev)
        neg_phi_w = -phi_w

        def run():
            A = A0
            for _ in range(n_spans):
                A = ssfm.ssfm_o4_scan_inside(A, phi_w, hs, g, a_km)
                A = A * float(gain)
            for _ in range(n_spans):
                A = A / float(gain)
                A = ssfm.ssfm_o4_scan_inside(A, neg_phi_w, hs, -g, -a_km)
            return A

        best, walls = _time(run, dev, reps=2)
    pairs = 3 * len(hs) * 2 * n_spans
    return n / best, _measured({
        "n_samples": n, "scheme": "o4", "h_km": h,
        "fft_pairs": pairs, "wall_s": round(best, 3),
        "rt_error": cal["o4"]["rt_error"],
        "rt_target": cal.get("rt_target"),
        "fwd_error_vs_independent_truth": cal["o4"].get("fwd_error"),
        "parity_rt_error": cal["parity"]["rt_error"],
        "capability_note": "o4 inverts the link at the absolute target; "
                           "the parity scheme's residual ~sqrt(2) means "
                           "it cannot invert at its bench settings — no "
                           "speedup-vs-parity is claimed",
        "metric_note": cal.get("metric")}, walls, peak)


def bench_wdm_batch(n_ch=16, n_bits=2**18, sps=16, device="cuda"):
    """BASELINE config 5 on one card: ``LinkProgram.dsp_wdm`` runs 16
    receiver-complete chains (a channel at a time) and their receivers
    (batched), scalars read back.  The defined configuration is 16 x 2^26
    samples sharded over two or more hosts; this row runs bench.py's
    single-device size, 16 x 2^22."""
    dev = check_device(device)
    n = n_bits * sps
    with _Peak(dev) as peak:
        prog = _build_ook_link((FiberSpec(**CFG), EDFASpec(G=10, NF=5)),
                               n_bits=n_bits, sps=sps, device=dev)
        bits, _ = prbs(23, length=n_ch * n_bits)
        bits = np.asarray(bits, np.uint8).reshape(n_ch, n_bits)
        box = {}

        def run():
            box["d"] = prog.dsp_wdm(n_ch, bits=bits, seed=5)

        best, walls = _time(run, dev, reps=2)
    return n_ch * n / best, _measured({
        "n_ch": n_ch, "n_per_ch": n, "wall_s": round(best, 3),
        "max_ber": float(np.max(box["d"].ber)),
        "shortfall": "defined size is 16 x 2^26 sharded over >=2 hosts; "
                     "this is bench.py's single-device size (16 x 2^22)"},
        walls, peak)


def bench_wdm_shard(n_bits=2**20, sps=64, device="cuda"):
    """BASELINE config 5's per-device shard: one channel of 2^26 samples,
    what each of 16 devices owns in the sharded configuration, through
    ``LinkProgram.jitted``."""
    rate, best, walls, peak = _jitted_cell(
        (FiberSpec(**CFG), EDFASpec(G=10, NF=5)), n_bits, sps, 6, 11, device)
    return rate, _measured({
        "n_samples": n_bits * sps, "wall_s": round(best, 3),
        "what": "1 ch x 2^26 full chain (per-chip shard of the 16-chip "
                "sharded config)"}, walls, peak)


def device_block(dev: torch.device) -> dict:
    """The device the numbers were taken on: for a card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them, and
    the number of cards."""
    block = {"type": dev.type, "torch": torch.__version__,
             "cuda": torch.version.cuda, "count": torch.cuda.device_count()}
    if dev.type != "cuda":
        return {**block, "name": "cpu", "power_limit": None}
    index = dev.index or 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = (s.strip() for s in smi.stdout.strip().split(","))
    return {**block, "name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(index)}


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--all", action="store_true",
                   help="also configs 3, 4, 5 and the receiver-complete "
                        "config 2; writes --out")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits without a card) or cpu")
    p.add_argument("--small", action="store_true",
                   help="every cell at 2^12-2^16 samples")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="where --all writes its rows (default "
                        "BENCH_ALL_CUDA.json beside this script)")
    args = p.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, "BENCH_ALL.json"):
        p.error("BENCH_ALL.json is the JAX package's record; give another "
                "--out")
    try:
        args.device = check_device(args.device)
    except RuntimeError as e:
        sys.exit(f"bench_cuda.py: {e}")
    return args


def _cell(name, fn, args, **kw):
    size = SMALL[name] if args.small else {}
    out = fn(**size, **kw, device=args.device)
    if out is not None:
        print(f"[bench_cuda] {name}: best {out[1]['wall_s']} s, walls "
              f"{out[1]['walls_s']}, peak {out[1]['peak_mem_gib']} GiB",
              file=sys.stderr, flush=True)
    return out


def main(argv=None) -> dict:
    """Run the cells, print the JSON line and return it as a dict."""
    args = _parse(argv)
    # the Triton kernel's build cache stays in this checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))

    ssfm_sps, ssfm_detail = _cell("ssfm_headline", bench_ssfm_headline, args)
    eqacc_sps, eqacc_detail = _cell("ssfm_equal_accuracy",
                                    bench_ssfm_equal_accuracy, args)
    chain_sps, chain_detail = _cell("full_chain", bench_full_chain, args)
    b2b_sps, b2b_detail = _cell("b2b_chain", bench_b2b_chain, args)

    detail = {
        **ssfm_detail,
        "equal_accuracy_samples_per_s": round(eqacc_sps, 1),
        "equal_accuracy": eqacc_detail,
        "full_chain_samples_per_s": round(chain_sps, 1),
        "full_chain_wall_s": chain_detail["wall_s"],
        "b2b_chain_samples_per_s": round(b2b_sps, 1),
    }
    ref = None
    if os.path.exists(BASELINE_PATH):
        with open(BASELINE_PATH) as f:
            ref = json.load(f)

    if args.all:
        ppm_sps, ppm_d = _cell("ppm", bench_ppm, args)
        dbp_sps, dbp_d = _cell("dbp", bench_dbp, args)
        dbp_o4 = _cell("dbp_o4", bench_dbp_o4, args)
        wdm_sps, wdm_d = _cell("wdm_batch", bench_wdm_batch, args)
        shard_sps, shard_d = _cell("wdm_shard", bench_wdm_shard, args)
        dsp_sps, dsp_d = _cell("fused_dsp", bench_fused_dsp, args)
        all_results = {
            "config1_b2b_chain": {"samples_per_s": round(b2b_sps, 1),
                                  **b2b_detail},
            "config2_ssfm_only": {"samples_per_s": round(ssfm_sps, 1),
                                  **ssfm_detail},
            "config2_ssfm_equal_accuracy": {
                "samples_per_s": round(eqacc_sps, 1), **eqacc_detail},
            "config2_full_chain": {"samples_per_s": round(chain_sps, 1),
                                   **chain_detail},
            "config2_full_dsp": {"samples_per_s": round(dsp_sps, 1),
                                 **dsp_d},
            "config3_ppm8_chain": {"samples_per_s": round(ppm_sps, 1),
                                   **ppm_d},
            "config4_dbp_20x80": {"samples_per_s": round(dbp_sps, 1),
                                  **dbp_d},
            **({"config4_dbp_o4_roundtrip": {
                "samples_per_s": round(dbp_o4[0], 1), **dbp_o4[1]}}
               if dbp_o4 else {}),
            "config5_wdm16_per_chip": {"samples_per_s": round(wdm_sps, 1),
                                       **wdm_d},
            "config5_shard_1x2e26": {"samples_per_s": round(shard_sps, 1),
                                     **shard_d},
        }
        # each row against the NumPy reference's rate on a CPU
        # (scripts/measure_reference.py --all)
        if ref is not None:
            ref_cfgs = ref.get("configs", {})
            for k, row in all_results.items():
                r = ref_cfgs.get(k) or (
                    ref_cfgs.get("config2_ssfm_only")
                    if k.startswith("config2") else None)
                if r and r.get("samples_per_s"):
                    row["vs_reference_cpu"] = round(
                        row["samples_per_s"] / r["samples_per_s"], 1)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**all_results, "device": device_block(args.device)},
                      f, indent=1)
        detail["all"] = {k: v["samples_per_s"]
                         for k, v in all_results.items()}

    vs = 0.0
    if ref is not None:
        if ref.get("samples_per_s"):
            vs = ssfm_sps / ref["samples_per_s"]
        # where the CPU reference's number came from and how noisy it was
        detail["baseline_denominator"] = {
            "samples_per_s": ref.get("samples_per_s"),
            "measured_at": ref.get("measured_at"),
            "reps": ref.get("reps"),
            "interleaved": ref.get("interleaved"),
            "spread": ref.get("configs", {}).get(
                "config2_ssfm_only", {}).get("spread"),
            "note": BASELINE_NOTE,
        }
    detail["device"] = device_block(args.device)

    line = {
        "metric": "ssfm_2e24_ook_throughput",
        "value": round(ssfm_sps, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(vs, 2),
        "detail": detail,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
