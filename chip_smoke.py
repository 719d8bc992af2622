#!/usr/bin/env python3
"""Smoke test of opticomlib_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- ``build_link`` -> ``LinkProgram.dsp`` on
BASELINE config 2 (OOK, PRBS15, 16 dBm, gaussian pulses, MZM, 50 km
phi_max-adaptive split-step fiber, EDFA with ASE, PIN with thermal and shot
noise, Bessel LPF, eye metrology, threshold, BER) at its full size, 2^18
bits x 64 samples per bit = 2^24 samples -- and checks it in phases, one
line each; any failure exits non-zero:

0. a CUDA card is present (prints ``nvidia-smi`` name and power limit);
1. the hand-written kernels build from the sources in this checkout;
2. each kernel agrees with its plain PyTorch version at the main path's
   shapes (tolerance 2e-5; histogram counts exact), and is timed beside it
   (median of 20 runs, CUDA events);
3. the link at 2^20 samples runs on the card and on the CPU on the same
   numpy noise draws, and the two agree;
4. the full slice runs once through the kernels (launch counters) and its
   result is held to the JAX package's pinned result.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
Compiled kernels go to ``build/`` in this checkout.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The JAX package's result for the full slice, taken on the CPU with
#   JAX_PLATFORMS=cpu python -c "import bench; \
#     from opticomlib_tpu.link import FiberSpec, EDFASpec; \
#     from opticomlib_tpu.ops.prbs import prbs; \
#     p = bench._build_ook_link( \
#         (FiberSpec(**bench.CFG), EDFASpec(G=10, NF=5)), n_bits=2**18); \
#     d = p.dsp(bits=prbs(15, length=2**18)[0], seed=3); e = d.eye; \
#     print(d.ber, d.n_errors, d.threshold, e.mu0, e.mu1, e.s0, e.s1)"
# (ssfm._ssfm_loop on the same launch field takes 58 steps.)  The noise
# draws differ between the frameworks, so the port is held to these
# statistically: threshold within 2 %, BER <= max(10 x, 1e-4), and the level
# means and spreads within 5 standard errors.  The eye uses 8192 slots, about
# 4096 per level, and the samples of one slot share its noise, so a level
# mean has standard error s / sqrt(4096) and a spread s / sqrt(2 * 4096).
PINNED = dict(n_steps=58, ber=0.0, threshold=0.72076, mu0=0.05682,
              mu1=1.00980, s0=0.04864, s1=0.02106)

N_BITS, SPS, R = 2**18, 64, 10e9
SMALL_BITS = 2**14   # phase 3: 2^20 samples
TOL = dict(rtol=2e-5, atol=2e-5)
REPLACES = {
    "nl_halfstep": ("triton", "opticomlib_tpu_torch/ops/triton_kernels.py",
                    "opticomlib_tpu/ops/pallas_kernels.py:81"),
    "cmul": ("triton", "opticomlib_tpu_torch/ops/triton_kernels.py",
             "opticomlib_tpu/ops/pallas_kernels.py:134"),
    "histogram2d": ("cuda", "opticomlib_tpu_torch/ops/csrc/histogram2d.cu",
                    "opticomlib_tpu/ops/pallas_kernels.py:342"),
}


def fail(phase: int, msg: str):
    print(f"phase {phase}: FAIL {msg}", flush=True)
    sys.exit(1)


def check(cond, phase: int, msg: str):
    if not cond:
        fail(phase, msg)


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs (CUDA
    events around each run, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def config2_spec(link):
    return link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=0.75 * R,
        stages=(link.FiberSpec(length=50.0, alpha=0.2, beta_2=-21.0,
                               gamma=1.3, phi_max=0.01),
                link.EDFASpec(G=10, NF=5)))


def main() -> None:
    import torch

    # ---- phase 0: the card ----
    if not torch.cuda.is_available():
        print("phase 0: FAIL torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(smi, 0, "nvidia-smi printed nothing")
    print(smi[0], flush=True)
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0 device: ok {kind}, {torch.cuda.device_count()} card(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # the port is imported from this checkout (the script's directory is
    # first on sys.path), never from an installed copy
    check((ROOT / "opticomlib_tpu_torch" / "__init__.py").is_file(), 1,
          f"no opticomlib_tpu_torch package beside {Path(__file__).name}")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import numpy as np
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.ops import _build, kernels
    from opticomlib_tpu_torch.ops.prbs import prbs
    from opticomlib_tpu_torch.params import SimParams

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.load_library()
    t_nvcc = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    :")[-1].strip() for ln in
             _build.library_path().with_suffix(".log").read_text()
             .splitlines() if "Used" in ln]
    t0 = time.perf_counter()
    a = torch.ones(8, dtype=torch.complex64, device=dev)
    kernels.cmul(*kernels.nl_halfstep(a, 0.1))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"phase 1 build: ok nvcc {t_nvcc:.2f} s, triton {t_triton:.2f} s; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    # ---- phase 2: each kernel against its plain version ----
    g = torch.Generator(device=dev).manual_seed(0)

    def field(*shape):
        # |A|^2 ~ 0.02 W, the slice's launch power
        return (torch.randn(shape, generator=g, device=dev,
                            dtype=torch.complex64) * 0.1).contiguous()

    coeff = 1.3 * 0.38553 / 2  # gamma * h0 / 2 of the slice's first step
    err = {k: 0.0 for k in REPLACES}
    for shape in [(2**24,), (2**24 + 5,), (2, 2**20)]:
        A = field(*shape)
        E = field(shape[-1])
        B, H = kernels.nl_halfstep(A, coeff)
        Br, Hr = kernels.nl_halfstep_ref(A, coeff)
        torch.testing.assert_close(B, Br, **TOL)
        torch.testing.assert_close(H, Hr, **TOL)
        err["nl_halfstep"] = max(err["nl_halfstep"], float(
            (B - Br).abs().max()), float((H - Hr).abs().max()))
        for other in (E, B):
            C, Cr = kernels.cmul(A, other), kernels.cmul_ref(A, other)
            torch.testing.assert_close(C, Cr, **TOL)
            err["cmul"] = max(err["cmul"], float((C - Cr).abs().max()))
    for n, nt, ny in [(2**20, 1, 4096), (2**20, 64, 256),
                      (2**20, 256, 1024)]:
        t = torch.randint(0, nt, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        y = torch.randint(-1, ny + 1, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        h, hr = kernels.histogram2d(t, y, nt, ny), kernels.histogram2d_ref(
            t, y, nt, ny)
        check(torch.equal(h, hr), 2, f"histogram2d ({nt}, {ny}) counts "
              f"differ: max |diff| {float((h - hr).abs().max())}")

    A, E = field(2**24), field(2**24)
    ybins = torch.randint(-1, 4096, (2**20,), generator=g, device=dev,
                          dtype=torch.int32)
    tzero = torch.zeros_like(ybins)
    ms = {
        "nl_halfstep": (cuda_ms(torch, lambda: kernels.nl_halfstep(A, coeff)),
                        cuda_ms(torch, lambda: kernels.nl_halfstep_ref(
                            A, coeff))),
        "cmul": (cuda_ms(torch, lambda: kernels.cmul(A, E)),
                 cuda_ms(torch, lambda: kernels.cmul_ref(A, E))),
        "histogram2d": (
            cuda_ms(torch, lambda: kernels.histogram2d(tzero, ybins, 1, 4096)),
            cuda_ms(torch, lambda: kernels.histogram2d_ref(tzero, ybins, 1,
                                                           4096))),
    }
    gbs = {k: 24 * 2**24 / (ms[k][0] * 1e-3) / 1e9
           for k in ("nl_halfstep", "cmul")}
    print("phase 2 kernels: ok " + "; ".join(
        f"{k} max_abs_err {err[k]:.3g}, {ms[k][0]:.4f} ms vs plain "
        f"{ms[k][1]:.4f} ms" + (f" ({gbs[k]:.0f} GB/s)" if k in gbs else "")
        for k in REPLACES), flush=True)
    del A, E, B, H, Br, Hr, C, Cr

    # ---- phase 3: card vs CPU on the same noise, 2^20 samples ----
    spec = config2_spec(link)
    params = SimParams.create(sps=SPS, R=R, _warn=False)
    n = SMALL_BITS * SPS
    rng = np.random.default_rng(7)
    noise = {"ase": [rng.standard_normal((4, n), dtype=np.float32)],
             "thermal": rng.standard_normal(n, dtype=np.float32),
             "shot": rng.standard_normal(n, dtype=np.float32)}
    bits = prbs(15, length=SMALL_BITS)[0]
    res = {}
    for name in ("cuda", "cpu"):
        prog = link.build_link(spec, SMALL_BITS, params, device=name)
        run = prog.run(bits=bits, noise=noise)
        res[name] = (run.v.cpu().numpy(), run.n_steps,
                     prog.dsp(bits=bits, noise=noise))
    (v_g, st_g, d_g), (v_c, st_c, d_c) = res["cuda"], res["cpu"]
    rel = float(np.linalg.norm(v_g - v_c) / np.linalg.norm(v_c))
    scan_step = abs(d_c.eye.mu1 - d_c.eye.mu0) / 999
    check(st_g == st_c, 3, f"n_steps card {st_g} vs CPU {st_c}")
    check(rel <= 1e-4, 3, f"v rel L2 {rel:.3g} > 1e-4")
    check(d_g.n_errors == d_c.n_errors, 3,
          f"n_errors card {d_g.n_errors} vs CPU {d_c.n_errors}")
    check(abs(d_g.threshold - d_c.threshold) <= scan_step * (1 + 1e-3), 3,
          f"threshold card {d_g.threshold} vs CPU {d_c.threshold}")
    print(f"phase 3 card-vs-cpu (2^20 samples): ok n_steps {st_g}, v rel L2 "
          f"{rel:.3g}, n_errors {d_g.n_errors}, threshold {d_g.threshold:.6f}"
          f" vs {d_c.threshold:.6f}", flush=True)

    # ---- phase 4: the full slice through the kernels ----
    prog = link.build_link(spec, N_BITS, params, device=dev)
    bits = prbs(15, length=N_BITS)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    d = prog.dsp(bits=bits, seed=3)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        prog.dsp(bits=bits, seed=3)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    e = d.eye
    check(d.n_steps == (PINNED["n_steps"],), 4,
          f"n_steps {d.n_steps} != ({PINNED['n_steps']},)")
    check(launches["nl_halfstep"] >= 58 and launches["cmul"] >= 116
          and launches["histogram2d"] >= 1, 4, f"launches {launches}")
    check(np.isfinite(d.threshold) and abs(d.threshold - PINNED["threshold"])
          <= 0.02 * PINNED["threshold"], 4,
          f"threshold {d.threshold} vs pinned {PINNED['threshold']}")
    check(d.ber <= max(10 * PINNED["ber"], 1e-4), 4, f"BER {d.ber}")
    for k, s_k, n_k in (("mu0", "s0", 4096), ("mu1", "s1", 4096),
                        ("s0", "s0", 8192), ("s1", "s1", 8192)):
        tol = 5 * PINNED[s_k] / np.sqrt(n_k)
        check(abs(getattr(e, k) - PINNED[k]) <= tol, 4,
              f"{k} {getattr(e, k)} vs pinned {PINNED[k]} +- {tol:.2g}")
    print(f"phase 4 slice (2^24 samples): ok n_steps {d.n_steps[0]}, BER "
          f"{d.ber} ({d.n_errors} errors), threshold {d.threshold:.5f} "
          f"(JAX {PINNED['threshold']}), mu0 {e.mu0:.5f} mu1 {e.mu1:.5f} "
          f"s0 {e.s0:.5f} s1 {e.s1:.5f}; launches {launches}; wall first "
          f"{t_first:.3f} s, then {', '.join(f'{w:.3f}' for w in walls)} s; "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": REPLACES[k][0], "source": REPLACES[k][1],
         "replaces": REPLACES[k][2], "launches": launches[k],
         "max_abs_err": err[k], "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
