#!/usr/bin/env python3
"""Smoke test of opticomlib_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full size, 2^24 samples a waveform: two
through ``build_link`` -> ``LinkProgram.dsp``,

* BASELINE config 2 (OOK, PRBS15, 16 dBm, gaussian pulses, MZM, 50 km
  phi_max-adaptive split-step fiber, EDFA with ASE, PIN with thermal and
  shot noise, Bessel LPF, eye metrology, threshold, BER), 2^18 bits x 64
  samples per bit;
* BASELINE config 4, the long-haul link: laser linewidth 100 kHz and RIN
  -150 dB/Hz, 20 x (80 km fixed-step 4th-order fiber + 16 dB EDFA with
  ASE), then 20 spans of per-span DBP, PIN, LPF, an 8-bit ADC on the
  99.99 % range, and the same receiver; 2^20 bits x 16 samples per bit;

and one through the staged drop-in API, the README quickstart:
``gv(sps=64, R=10e9, Vpi=5, N=2**18)`` (the card is ``gv``'s default device;
the last run leaves ``device="cuda"`` out to show it), ``PRBS`` (order 15)
-> ``DAC`` (gaussian, pulse shaped by the ``fir_filter`` kernel) ->
``MZM(LASER(P0=5))`` -> ``FIBER`` (50 km, phi_max-adaptive) -> ``PD`` (all
noise) -> ``ook.DSP`` -> ``ook.BER_analizer``; 2^18 bits x 64;

and the receivers beyond OOK, through ``LinkProgram.dsp_ppm``, ``dsp_wdm``,
``dsp_wdm_ppm`` and ``eye``:

* BASELINE config 3: 8-PPM, 2^16 symbols = 2^19 slots x 32 samples, 16 dBm,
  20 km phi_max-adaptive fiber, PIN with thermal and shot noise, soft
  (per-symbol argmax) and hard (eye metrology, KDE threshold, HDD repair)
  decisions;
* BASELINE config 5: a 16-channel WDM sweep, each channel config 2's physics
  at 16 samples per bit on its own PRBS23 segment and noise stream, 2^20
  bits a channel (16 x 2^24 samples), and once at the configuration's
  defined 2^22 bits a channel (16 x 2^26 samples); the KDE histograms of
  the 16 receivers are one ``histogram_rows`` launch at (16, 4096).

It checks them in phases, one line each; any failure exits non-zero:

0. a CUDA card is present (prints ``nvidia-smi`` name and power limit);
1. the hand-written kernels build from the sources in this checkout (one
   ``nvcc`` per CUDA source, started together, and Triton);
2. each kernel agrees with its plain PyTorch version at the main paths'
   shapes (``nl_halfstep`` to 2e-5; ``cmul``, histogram counts and ADC
   outputs bit for bit; ``cmul`` also at an odd length and on views 8 bytes
   off a 16-byte boundary; the histograms by rows at (1, 4096) on a real eye
   window and on uniform bins, at (16, 4096) and (16, 8192), by pairs at
   (256, 256), (16, 8192) and a table on the global-atomic path, all-masked
   and empty input, indices out of range on both sides, odd lengths and
   views 4, 8 and 12 bytes off a 16-byte boundary), and is timed beside it
   and, where one PyTorch call computes the same function, beside that call
   (median of 20 runs, CUDA events);
3. config 2 at 2^20 samples runs on the card and on the CPU on the same
   numpy noise draws, and the two agree;
4. config 2 at full size runs once through the kernels (launch counters)
   and its result is held to the JAX package's pinned result;
5. config 4 at 2^20 samples runs on the card and on the CPU on the same
   numpy noise draws, and the two agree (the voltage before the ADC to
   relative L2 1e-3; after it, a code moves by one level where round-off
   puts a sample across a decision boundary);
6. config 4 at full size runs once through the kernels and is held to the
   JAX package's pinned result;
7. the same 40 spans without noise undo themselves: the field after them
   is the launch field to relative L2 0.01;
8. the ``fir_filter`` kernel agrees with its plain version (``conv1d``) to
   1e-5 of max|y| at the DAC's shapes (2^24 samples, 783 gaussian and 64
   nrz taps), an odd length, more taps than its 1024-output block, and 1,
   7, 8, 9 and 8192 taps (around its 8-tap chunk, and its limit), and is
   timed beside the plain version and the FFT convolution the DAC takes
   above the kernel's limit;
9. the staged chain at 2^20 samples runs on the card and on the CPU on the
   same ``np.random`` draws, and the two agree;
10. the staged chain at full size runs through the kernels under a fixed
    ``np.random.seed`` and is held to the JAX package's pinned result on
    the same seed, then once with ``gv(seed=...)`` on-device noise and no
    device named, held statistically;
11. config 3 at 2^20 samples runs on the card and on the CPU on the same
    numpy noise and HDD draws, soft and hard: equal error counts, the KDE
    threshold within two steps of its 500-point grid (plus the width of the
    flat stretch of the density it is the minimum of);
12. config 3 at full size, soft and hard, through the kernels, held to the
    JAX package's pinned result;
13. config 5: at 2^20 samples a channel the 16-channel sweep equals 16
    ``dsp(seed=5 + c)`` calls (error and step counts equal, thresholds rel
    1e-6, levels rel 1e-5); then the sweep at 16 x 2^24 (first and steady
    wall time, peak memory, one histogram launch a sweep) and once at
    16 x 2^26, every channel held to the JAX package's pinned channel; then
    ``dsp_wdm_ppm(4, M=8, decision="hard")`` on config 3's physics at 2^22
    samples a channel against ``dsp_ppm`` a channel;
14. ``LinkProgram.eye`` on config 2 at full size gives ``dsp``'s eye
    scalars; with traces, the traces stay on the card and the (256, 256)
    density through ``histogram2d`` equals ``np.histogram2d`` of the same
    traces exactly.

15. the resumable fiber on the card at 2^24 samples (config 2's launch
    field and fiber): ``ssfm_propagate_resumable(segment_km=10)`` run whole,
    then killed after its second save and resumed: the same bits as the
    whole run, the unsegmented ``ssfm_propagate`` to 2e-4 of the peak (the
    adaptive segments take other steps) and, at a fixed h, to the JAX
    test's tolerance; ``span_chain_resumable`` over 4 of config 4's spans (80 km o4
    at h = 20 km + gain + ASE keyed by the span) the same way; wall time with
    and without checkpoints, bytes and seconds a save;
16. the sharded fiber at world size 1 over NCCL: ``initialize_multihost``
    (one rank, file rendezvous), ``make_link_mesh(1, 1)``, ``ssfm_sharded``
    on the same field, pencil phi_max-adaptive (step count equal to
    ``ssfm_propagate``'s, field to 5e-4 of the peak), pencil fixed h,
    overlap fixed h (a rank that is its own ring neighbour, 5e-3), o4 fixed
    on one config-4 span, and ``FIBER(mesh=)`` through ``gv`` with no device
    named; each wall time beside the unsharded call's and beside that
    call's steps alone (its phase grid kept on the card);
17. profiling: one config-2 ``dsp`` under ``trace`` with ``annotate("ssfm")``
    around the fiber: the Chrome trace holds the region and the
    ``nl_halfstep`` kernel; ``DeviceTimer`` agrees with CUDA events on that
    call within 5 %;
18. the sharded fused link at world size 1 over NCCL, on phase 16's mesh:
    ``build_link(mesh=).jitted`` against ``LinkProgram`` at 2^20 samples
    (config 2 and 4 noiseless, and on the same injected draws; steps equal,
    v within 2e-5 of the peak, 5e-5 for config 4's 40 spans); config 2 and
    config 4 ``ShardedLinkProgram.dsp`` at 2^24 held to the JAX pins (config
    4 through the sharded ADC range and the ``adc_quantize`` kernel); config
    5 ``dsp_wdm(16)`` of the sharded program at 16 x 2^24 (per-channel steps
    equal to phase 13's sweep, every channel to the JAX pins, peak memory);
    ``LinkProgram.dsp_wdm(16, mesh=)`` over a 1-D 'wdm' mesh equal to phase
    13's sweep; ``PD(FIBER(x, mesh=))`` at 2^24 against ``PD(FIBER(x))``;
    each with its first and steady wall time beside the unsharded call's,
    and its launches;
19. the span-pipelined link at world size 1 over NCCL, ``make_span_mesh(1)``
    (S = 1: the 40 segments on the one rank, every move a local copy; 4
    channels, not 16, to keep the script within its time): config 4
    pipelined on the card against the sequential ``LinkProgram`` on the CPU
    on the same numpy draws, 2 x 2^18 samples, the voltage before the ADC to
    relative L2 1e-3; config 4 noiseless ``dsp_wdm(2)`` at 2 x 2^20 against
    ``LinkProgram.dsp_wdm`` (BER equal, thresholds and ``mu1`` rtol 1e-4);
    ``build_link(span_mesh=).dsp_wdm(4)`` at 4 x 2^24 (first and two steady
    calls, peak memory, launches; every channel held to config 4's JAX pins;
    the same seed again equal, another seed moving the thresholds);
    ``span_pipeline`` of 4 microbatches of 2^24 samples through config 2's
    50 km adaptive fiber with ASE on injected draws, within 5e-4 of the peak
    of the span applied to each by hand;
20. the staged leftovers at 2^24 samples, on the staged README chain's grid
    (fs = 640 GHz): 20.1 the ``fbg_rk4`` kernel against its plain loop on
    the card at 2^20 bins for two gratings (uniform kL = 2, 512 RK4 steps;
    gaussian-apodized kL = 8 chirped F = 10, 1587 steps; R and S to 1e-4 of
    their peak, H = S/R to 1e-4) and at the main path's 2^24 bins for
    both, timed at 2^24 beside its bound and the plain loop; 20.2 ``FBG`` on the chain's
    modulated field at 2^24 for both gratings (the uniform one's peak |H|
    within 1e-3 of tanh 2, and the card against the CPU at 2^20 on the same
    input to 1e-4); 20.3 ``FIBER(return_steps=True)`` on config 2's launch
    field at 2^24 (50 km, phi_max-adaptive): the step count equal to the
    JAX package's ``_ssfm_trajectory`` pinned on the CPU, the last frame's
    peak power and the last step's start to the pin, the frames at 2^20 on
    the card against the CPU, launches, wall time, peak memory; 20.4
    ``GET_EYE(engine="host")`` on the chain's PD output at 2^24 against the
    device engine (levels and crossings to 2e-4, the threshold to 2e-4 or
    within the KDE plateau plus two grid steps).

The line before the last is a JSON object with, for each kernel, its
launches (summed over the counted runs of the paths; per path under
``launches_by_path``), its error, its time, the plain version's, the
library call's where there is one (``library_ms``, else null) and its bound
``bound_ms``: the least time the card could take, the larger of the bytes
the function must move over 3.35 TB/s and its float32 operations over
67 TFLOP/s (``bound_by`` says which); the last line is
``{"ok": true, "device": {...}}``.  Compiled kernels go to ``build/`` in
this checkout.
"""
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

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

# The JAX package's result for config 4 (the spec of ``config4_spec``),
# taken on the CPU at 2^16 bits x 16 = 2^20 samples (bench.py bench_dbp's
# length) with
#   JAX_PLATFORMS=cpu python -c "from opticomlib_tpu.link import *; \
#     from opticomlib_tpu.ops.prbs import prbs; \
#     from opticomlib_tpu.params import SimParams; \
#     p = build_link(<config4_spec with the JAX classes>, 2**16, \
#         params=SimParams.create(sps=16, R=10e9)); \
#     d = p.dsp(bits=prbs(15, length=2**16)[0], seed=3); e = d.eye; \
#     print(d.ber, d.threshold, e.mu0, e.mu1, e.s0, e.s1)"
# The eye uses 8192 slots at either length, so the same statistical checks
# as config 2 apply.  The noiseless round trip (ASE and laser noise off,
# ``return_field=True``, against the back-to-back field) gave 1.140e-4 there.
PINNED4 = dict(ber=0.0, threshold=0.128878, mu0=0.0174689, mu1=0.2405096,
               s0=0.0121167, s1=0.0121554, round_trip=1.140e-4)

# The JAX package's result for the staged README chain (phase 10), taken on
# the CPU with the same seed:
#   JAX_PLATFORMS=cpu python -c "import numpy as np; \
#     from opticomlib_tpu import gv; from opticomlib_tpu.devices import *; \
#     from opticomlib_tpu.models import ook; \
#     gv(sps=64, R=10e9, wavelength=1550e-9, Vpi=5, N=2**18); \
#     np.random.seed(1); tx = PRBS(order=15, len=gv.N); \
#     v = DAC(tx, Vpp=5, offset=-2.5, pulse_shape='gaussian'); \
#     mod = MZM(LASER(P0=5), v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=26); \
#     fib = FIBER(mod, length=50, alpha=0.2, beta_2=-20, gamma=2); \
#     pdo = PD(fib, BW=7.5e9, r=1, include_noise='all'); \
#     rx, e, rth = ook.DSP(pdo); \
#     print(ook.BER_analizer('counter', Tx=tx, Rx=rx), rth, \
#           e.mu0, e.mu1, e.s0, e.s1)"
# (ssfm._ssfm_loop, which that FIBER runs, takes 9 steps.)  The JAX DSP
# measures its eye with the host NumPy engine, the port with the twin of the
# device engine (tests/test_eye_device.py holds the two to 2e-4).
PINNED_STAGED = dict(seed=1, n_steps=9, ber=0.0, threshold=0.0059514299287740475,
                     mu0=5.757647879658798e-4, mu1=7.698164623068478e-3,
                     s0=4.884072839667364e-4, s1=1.5737999351354606e-4)

# The JAX package's result for config 3 (phase 12), taken on the CPU with
#   JAX_PLATFORMS=cpu python -c "import bench; \
#     from opticomlib_tpu.link import FiberSpec; \
#     from opticomlib_tpu.ops.prbs import prbs; \
#     p = bench._build_ook_link((FiberSpec(length=20, alpha=0.2, \
#         beta_2=-21.0, gamma=1.3),), n_bits=N_SYM * 8, sps=32); \
#     d = p.dsp_ppm(8, decision='hard', bits=prbs(15, length=N_SYM * 3)[0], \
#                   seed=3); e = d.eye; \
#     print(d.ber, d.threshold, e.mu0, e.mu1, e.s0, e.s1)"
# at N_SYM = 2^16, 2^24 samples (soft: BER 0.0 there too).  Of the 8192 eye
# slots one in eight is ON, so the ON level rests on about 1024 slots and
# the OFF level on 7168.  ``s1`` is 0.3 % of ``mu1`` at this power, so a
# level is held to 5 standard errors or 1e-3 of its value, whichever is
# larger (the CPU parity tests hold float32 reductions to 1e-4).
# The KDE threshold is the minimum of a density that is flat (zero) over most
# of the eye opening at this SNR: it is held to the pin within 2 % plus the
# width of that flat stretch, which the receiver reports.
PINNED3 = dict(ber=0.0, threshold=0.2106698, mu0=0.00760770, mu1=0.3787725,
               s0=0.01016777, s1=0.00098308)

# The JAX package's result for config 5 (phase 13), taken on the CPU at 2^16
# bits x 16 a channel with
#   JAX_PLATFORMS=cpu python -c "import bench, numpy as np; \
#     from opticomlib_tpu.link import FiberSpec, EDFASpec; \
#     from opticomlib_tpu.ops.prbs import prbs; \
#     p = bench._build_ook_link((FiberSpec(**bench.CFG), \
#         EDFASpec(G=10, NF=5)), n_bits=2**16, sps=16); \
#     bits = np.asarray(prbs(23, length=16 * 2**16)[0].data, \
#                       np.uint8).reshape(16, -1); \
#     r = np.array([(d.threshold, d.eye.mu0, d.eye.mu1, d.eye.s0, d.eye.s1) \
#         for d in (p.dsp(bits=bits[c], seed=5 + c, sps_resamp=None) \
#                   for c in range(16))]); \
#     print(r.mean(0), r.std(0, ddof=1))"
# (every channel BER 0).  The channels differ by more than the noise on a
# level explains (each has its own PRBS23 segment in its 8192 eye slots:
# mu1 spreads by 1.6 standard errors of one channel's noise), so the pin is
# the mean over the 16 channels and its spread their standard deviation;
# every channel of a sweep, at any length, is held to the mean within 5
# such deviations.
# The JAX package's trajectory of config 2's launch field at 2^24 samples
# (phase 20.3), taken on the CPU by the loop of ``ops.ssfm._ssfm_trajectory``
# (the frames not kept; the launch field from ``build_link(<config 2 with
# stages=()>, 2**18, return_field=True)`` on ``prbs(15)``, 50 km, alpha 0.2,
# beta_2 -21, gamma 1.3, phi_max 0.01): 58 steps, the last starting at
# z = 49.033213413556524 km, and max|A|^2 of the last frame 0.002851787954568863
# W.  At 2^20 samples it takes 58 steps too.
PINNED_TRAJ = dict(n_steps=58, z_last_start=49.033213413556524,
                   max_power_last=0.002851787954568863)

PINNED5 = dict(ber=0.0, threshold=0.740273, mu0=0.0596429, mu1=1.0102078,
               s0=0.0462687, s1=0.0182648)
PINNED5_STD = dict(threshold=0.0038877, mu0=0.0015346, mu1=0.00046230,
                   s0=0.00049552, s1=0.00021886)

N_BITS, SPS, R = 2**18, 64, 10e9
M3, N_SYM3, SPS3 = 8, 2**16, 32      # config 3: 2^19 slots x 32 = 2^24
SMALL_SYM3 = 2**12                   # phase 11: 2^15 slots x 32 = 2^20
N_CH5, N_BITS5, SPS5 = 16, 2**20, 16  # config 5: 16 x 2^24 samples
DEFINED_BITS5 = 2**22                # ... and as defined: 16 x 2^26
SMALL_BITS5 = 2**16                  # phase 13: 2^20 samples a channel
WDM_PPM_CH, WDM_PPM_SYM = 4, 2**14   # phase 13: 4 x (2^17 slots x 32)
N_BITS4, SPS4 = 2**20, 16
SMALL_BITS = 2**14   # phase 3: 2^20 samples
SMALL_BITS4 = 2**16  # phase 5: 2^20 samples
SMALL_BITS_STAGED = 2**14  # phase 9: 2^20 samples
TOL = dict(rtol=2e-5, atol=2e-5)
REPLACES = {
    "nl_halfstep": ("triton", "opticomlib_tpu_torch/ops/triton_kernels.py",
                    "opticomlib_tpu/ops/pallas_kernels.py:81"),
    "cmul": ("cuda", "opticomlib_tpu_torch/ops/csrc/cmul.cu",
             "opticomlib_tpu/ops/pallas_kernels.py:134"),
    "histogram2d": ("cuda", "opticomlib_tpu_torch/ops/csrc/histogram2d.cu",
                    "opticomlib_tpu/ops/pallas_kernels.py:342"),
    "adc_quantize": ("cuda", "opticomlib_tpu_torch/ops/csrc/adc_quantize.cu",
                     "opticomlib_tpu/ops/pallas_kernels.py:289"),
    "fir_filter": ("cuda", "opticomlib_tpu_torch/ops/csrc/fir_filter.cu",
                   "opticomlib_tpu/ops/pallas_kernels.py:168"),
    "fbg_rk4": ("cuda", "opticomlib_tpu_torch/ops/csrc/fbg_rk4.cu",
                "opticomlib_tpu/devices.py:1127 (_fbg_rk4, lax.scan)"),
}

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 3.35 TB/s; float32
# outside the tensor cores 67 TFLOP/s (an FMA is two operations).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12


def bound_ms(n_bytes: float, n_flop: float):
    """The least time for ``n_bytes`` moved (each input read once, each
    output written once) and ``n_flop`` float32 operations: the larger of
    bytes / 3.35 TB/s and flop / 67 TFLOP/s, in ms, and which one it is."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_flop = n_flop / PEAK_FP32_FLOP_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_flop
            else (t_flop, "operations"))


def fail(phase: int, msg: str):
    print(f"phase {phase}: FAIL {msg}", flush=True)
    sys.exit(1)


def check(cond, phase: int, msg: str):
    if not cond:
        fail(phase, msg)


def cuda_ms(torch, fn, reps: int = 20, inner: int = 1) -> float:
    """Median device time of one ``fn()`` in ms over ``reps`` runs (CUDA
    events around ``inner`` calls in a row, after one warm-up).  With
    ``inner = 1`` the time includes the host's work between the first event
    and the launch (the wrapper, the allocation, the binding); with more,
    the launches queue behind one another as they do on the paths, and the
    host's share drops out unless the host is the slower side."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timed(torch, *fns, reps: int = 20):
    """``(single, queued)``: each of ``fns`` timed one launch at a time, and
    ten in a row."""
    return (tuple(cuda_ms(torch, f, reps) for f in fns),
            tuple(cuda_ms(torch, f, reps, inner=10) for f in fns))


def config2_spec(link):
    return link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=0.75 * R,
        stages=(link.FiberSpec(length=50.0, alpha=0.2, beta_2=-21.0,
                               gamma=1.3, phi_max=0.01),
                link.EDFASpec(G=10, NF=5)))


def config4_spec(link, noisy=True):
    """BASELINE config 4: 0.005 W marks (10 dBm, 3 dB MZM loss), 20 x 80 km
    of fixed-step (h = 20 km) 4th-order fiber with 16 dB EDFAs, 20 spans of
    per-span DBP; ``noisy=False`` drops the ASE, laser noise and ADC."""
    span = dict(length=80.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                method="o4", h=20.0)
    laser = dict(lw=1e5, rin=-150.0, adc_bits=8) if noisy else {}
    return link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=10.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=0.75 * R,
        stages=(link.RepeatSpec(20, (link.FiberSpec(**span), link.EDFASpec(
                    G=16, NF=5 if noisy else None))),
                link.RepeatSpec(20, (link.DBPSpec(undo_gain_dB=16, **span),
                                     ))), **laser)


def hold_to_pin(d, pin, phase: int, slots=(4096, 4096), rel_floor=0.0,
                threshold_slack=0.0):
    """Threshold within 2 % (plus ``threshold_slack``), BER <= max(10 x,
    1e-4), the level means and spreads within 5 standard errors of the
    pinned JAX result, or within ``rel_floor`` of it where that is more.
    ``slots``: eye slots behind the OFF and the ON level (8192 in all: about
    4096 a level for OOK; the samples of one slot share its noise)."""
    e = d.eye
    check(np.isfinite(d.threshold) and abs(d.threshold - pin["threshold"])
          <= 0.02 * pin["threshold"] + threshold_slack, phase,
          f"threshold {d.threshold} vs pinned {pin['threshold']}")
    check(d.ber <= max(10 * pin["ber"], 1e-4), phase, f"BER {d.ber}")
    for k, s_k, n_k in (("mu0", "s0", slots[0]), ("mu1", "s1", slots[1]),
                        ("s0", "s0", 2 * slots[0]), ("s1", "s1", 2 * slots[1])):
        tol = max(5 * pin[s_k] / np.sqrt(n_k), rel_floor * abs(pin[k]))
        check(abs(getattr(e, k) - pin[k]) <= tol, phase,
              f"{k} {getattr(e, k)} vs pinned {pin[k]} +- {tol:.2g}")


def threshold_spread(pin, slots=(4096, 4096)) -> float:
    """Standard deviation of the difference between two OOK thresholds of
    the same link on independent noise: the threshold is near the point
    where both levels' tails meet, r = (mu1 s0 + mu0 s1) / (s0 + s1), and
    its standard error follows from those of the level means (s / sqrt(N))
    and spreads (s / sqrt(2 N)) that ``hold_to_pin`` uses."""
    mu0, mu1, s0, s1 = (pin[k] for k in ("mu0", "mu1", "s0", "s1"))
    r = (mu1 * s0 + mu0 * s1) / (s0 + s1)
    n0, n1 = slots
    var = ((s0 / (s0 + s1)) ** 2 * s1 ** 2 / n1
           + (s1 / (s0 + s1)) ** 2 * s0 ** 2 / n0
           + ((mu1 - r) / (s0 + s1)) ** 2 * s0 ** 2 / (2 * n0)
           + ((r - mu0) / (s0 + s1)) ** 2 * s1 ** 2 / (2 * n1))
    return float(np.sqrt(2 * var))


def config3_spec(link):
    """BASELINE config 3: config 2's transmitter and photodiode around 20 km
    of phi_max-adaptive fiber, no amplifier."""
    return link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=0.75 * R,
        stages=(link.FiberSpec(length=20.0, alpha=0.2, beta_2=-21.0,
                               gamma=1.3, phi_max=0.01),))


def timed_call(torch, kernels, fn, steady: int = 1):
    """``fn()`` once from zeroed launch counters, then ``steady`` more
    times; returns (result, launches of the first call, first wall, steady
    walls, peak memory over all calls)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    d = fn()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    walls = []
    for _ in range(steady):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return d, launches, t_first, walls, torch.cuda.max_memory_allocated()


def timed_dsp(torch, kernels, prog, bits, seed=3, steady=3):
    """One ``dsp`` call from zeroed launch counters, then ``steady`` more;
    returns (result, launches of the first call, first wall, steady walls,
    peak memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    d = prog.dsp(bits=bits, seed=seed)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(steady):
        t0 = time.perf_counter()
        prog.dsp(bits=bits, seed=seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return d, launches, t_first, walls, peak


def staged_chain(torch, n_bits, device, np_seed=None, gv_seed=None,
                 timed=False):
    """The README quickstart through the staged API on ``device`` (``None``:
    no device named, ``gv``'s default), legacy noise under
    ``np.random.seed(np_seed)`` or on-device noise from
    ``gv(seed=gv_seed)``.  With ``timed``, each device call ends in
    ``torch.cuda.synchronize()`` and its host wall time is recorded."""
    from opticomlib_tpu_torch import devices as D, gv, ook
    walls = {}

    def call(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if timed:
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        return out

    gv.default()
    gv(sps=SPS, R=R, wavelength=1550e-9, Vpi=5, N=n_bits,
       **({} if device is None else {"device": device}),
       **({} if gv_seed is None else {"seed": gv_seed}))
    if np_seed is not None:
        np.random.seed(np_seed)
    t0 = time.perf_counter()
    tx = call("PRBS", D.PRBS, order=15, len=gv.N)
    v = call("DAC", D.DAC, tx, Vpp=5, offset=-2.5, pulse_shape="gaussian")
    laser = call("LASER", D.LASER, P0=5)
    mod = call("MZM", D.MZM, laser, v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=26)
    fib = call("FIBER", D.FIBER, mod, length=50, alpha=0.2, beta_2=-20,
               gamma=2)
    pdo = call("PD", D.PD, fib, BW=0.75 * R, r=1, include_noise="all")
    rx, eye, rth = call("ook.DSP", ook.DSP, pdo)
    ber = call("BER_analizer", ook.BER_analizer, "counter", Tx=tx, Rx=rx)
    if timed:
        walls["chain"] = time.perf_counter() - t0
    n_err = int(np.sum(tx.data != rx.data))
    gv.default()
    return dict(v=pdo.to_numpy(), n_steps=fib.n_steps, ber=ber, n_err=n_err,
                threshold=rth, eye=eye, walls=walls, device=pdo.device.type)


#: how far the adaptive trajectory's positions may drift between the card
#: and a CPU (km, 1e-4 of the 50 km span): each step is phi_max / (gamma
#: max|A|^2), and max|A|^2 of fields that differ by FFT round-off differs by
#: ~2e-5 relative (the last frame's, card against the JAX pin), so the sum
#: of 57 such steps moves by a few 1e-5 of the span
Z_TOL_KM = 5e-3
#: float32 operations a bin and RK4 step of the coupled-mode equations, the
#: least the function needs: three detunings delta + s p - F z (3 each; the
#: chirp terms F z are the same for every bin and made once a step) and
#: couplings k p (1 each), four derivatives (8 products, 4 sums), three
#: stage states (4 products and 4 sums each) and the update k1 + 2 (k2 + k3)
#: + k4, times dz/6, plus R (6 for each of R, S's 4 floats)
FBG_FLOP_PER_STEP = 3 * 3 + 3 + 4 * 12 + 3 * 8 + 4 * 6
#: the two gratings of phase 20: a uniform one (the JAX tests') and a
#: gaussian-apodized chirped one, both on the chain's centre frequency
FBG_GRATINGS = {"uniform kL=2": dict(kL=2.0, apodization="uniform", F=0.0),
                "gaussian kL=8 F=10": dict(kL=8.0, apodization="gaussian",
                                           F=10.0)}


def fbg_inputs(n: int, kL: float, apodization, F: float, dev) -> tuple:
    """The ``fbg_rk4`` arguments of ``FBG(fc=f0, vdneff=1e-4, kL=kL,
    apodization=apodization, F=F)`` on an ``n``-bin grid at the staged
    chain's rate, made by the code ``devices.FBG`` runs; the step count is
    the last."""
    from scipy.constants import c, pi

    from opticomlib_tpu_torch import devices as D
    f0 = c / 1550e-9
    lam_D, L, dneff, vdneff = D._fbg_resolve_geometry(
        1.45, 1.0, None, f0, kL, None, None, None, 1e-4)
    w = 2 * pi * np.fft.fftshift(np.fft.fftfreq(n, 1 / (SPS * R)))
    lam = 2 * pi * c / (w + 2 * pi * f0)
    return D._fbg_rk4_inputs(lam, 1.45, lam_D, L, dneff, vdneff, apodization,
                             F, dev)


def fbg_errors(torch, kernels, args) -> tuple:
    """``fbg_rk4`` against ``fbg_rk4_ref`` on the same arguments: the larger
    error of R and S over their peak, that of H = S/R, the largest absolute
    error of R and S, and the plain loop's wall time in ms (one call)."""
    R_, S_ = kernels.fbg_rk4(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Rr, Sr = kernels.fbg_rk4_ref(*args)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    e_rs = max(float((R_ - Rr).abs().max() / Rr.abs().max()),
               float((S_ - Sr).abs().max() / Sr.abs().max()))
    e_h = float((S_ / R_ - Sr / Rr).abs().max())
    e_abs = float(max((R_ - Rr).abs().max(), (S_ - Sr).abs().max()))
    return e_rs, e_h, e_abs, plain


def staged_leftovers(torch, kernels, link, prbs, spec, params, dev):
    """Phase 20: the grating kernel, ``FBG``, the fiber's trajectory and the
    host eye engine at 2^24 samples.  Returns the kernel numbers of
    ``fbg_rk4`` for the JSON line and the launches of each path."""
    from opticomlib_tpu_torch import devices as D, gv
    from opticomlib_tpu_torch.signals import OpticalSignal
    t20 = time.perf_counter()
    out = {"launches": {}}

    # 20.1 the kernel against its plain loop at 2^20 bins and at the main
    # path's 2^24 (one call of each there; the plain loop is ~75 tensor
    # passes a step), and its time
    errs = []
    for label, g in FBG_GRATINGS.items():
        a20 = fbg_inputs(2**20, dev=dev, **g)
        n_steps = a20[-1]
        e_rs, e_h, e_abs, _ = fbg_errors(torch, kernels, a20)
        check(e_rs <= 1e-4 and e_h <= 1e-4, 20,
              f"fbg_rk4 {label} at 2^20: R, S off by {e_rs:.3g} of the "
              f"peak, H by {e_h:.3g} (1e-4)")
        errs.append(e_abs)
        n24 = 2**24
        a24 = fbg_inputs(n24, dev=dev, **g)
        e24_rs, e24_h, e_abs, plain24 = fbg_errors(torch, kernels, a24)
        check(e24_rs <= 1e-4 and e24_h <= 1e-4, 20,
              f"fbg_rk4 {label} at 2^24: R, S off by {e24_rs:.3g} of the "
              f"peak, H by {e24_h:.3g} (1e-4)")
        errs.append(e_abs)
        k_ms = cuda_ms(torch, lambda: kernels.fbg_rk4(*a24), reps=5)
        k20_ms = cuda_ms(torch, lambda: kernels.fbg_rk4(*a20), reps=5)
        p20_ms = cuda_ms(torch, lambda: kernels.fbg_rk4_ref(*a20), reps=1)
        b24 = bound_ms(28 * n24 + 16 * n_steps,
                       FBG_FLOP_PER_STEP * n24 * n_steps)
        b20 = bound_ms(28 * 2**20 + 16 * n_steps,
                       FBG_FLOP_PER_STEP * 2**20 * n_steps)
        out[label] = dict(n_steps=n_steps, ms24=k_ms, bound24=b24,
                          plain24=plain24, ms20=k20_ms, plain20=p20_ms,
                          bound20=b20)
        print(f"phase 20.1 fbg_rk4 {label} ({n_steps} steps): ok R, S to "
              f"{e_rs:.2g} of the peak and H to {e_h:.2g} at 2^20 bins, "
              f"{e24_rs:.2g} and {e24_h:.2g} at 2^24; 2^24 bins {k_ms:.3f} "
              f"ms (bound {b24[0]:.3f} ms, {b24[1]}; {b24[0] / k_ms:.0%}) vs "
              f"plain {plain24:.0f} ms (one call); 2^20 bins {k20_ms:.3f} ms "
              f"vs plain {p20_ms:.1f} ms (bound {b20[0]:.4f} ms)", flush=True)
        del a20, a24
    out["err"] = max(errs)

    # 20.2 FBG on the staged chain's modulated field
    gv.default()
    gv(sps=SPS, R=R, wavelength=1550e-9, Vpi=5, N=N_BITS, device="cuda")
    np.random.seed(20)
    tx = D.PRBS(order=15, len=gv.N)
    v = D.DAC(tx, Vpp=5, offset=-2.5, pulse_shape="gaussian")
    mod = D.MZM(D.LASER(P0=5), v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=26)
    check(mod.size == 2**24 and mod.device.type == "cuda", 20,
          f"chain field {mod.size} on {mod.device}")
    for label, g in FBG_GRATINGS.items():
        kw = dict(fc=gv.f0, vdneff=1e-4, kL=g["kL"],
                  apodization=g["apodization"], F=g["F"])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y, H = D.FBG(mod, print_params=False, retH=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        out["launches"]["fbg " + label] = launches
        peak = float(np.abs(H).max())
        ok = (launches["fbg_rk4"] == 1 and y.signal.shape == mod.signal.shape
              and bool(torch.isfinite(torch.view_as_real(y.signal)).all())
              and np.isfinite(H).all() and 0.9 < peak <= 1 + 1e-3)
        if g["apodization"] == "uniform":
            ok = ok and abs(peak - np.tanh(g["kL"])) <= 1e-3
        check(ok, 20, f"FBG {label}: launches {launches}, peak |H| {peak}, "
              f"output {tuple(y.signal.shape)}")
        print(f"phase 20.2 FBG {label} (2^24 samples): ok peak |H| "
              f"{peak:.6f}" + (f" (tanh {np.tanh(g['kL']):.6f})"
                               if g["apodization"] == "uniform" else "")
              + f"; wall {wall:.2f} s; launches {launches}", flush=True)
        del y, H
    # the card against the CPU at 2^20 on the same input
    g = FBG_GRATINGS["uniform kL=2"]
    x = mod.signal[: 2**20].cpu()
    res = {}
    for where in ("cuda", "cpu"):
        gv(sps=SPS, R=R, wavelength=1550e-9, N=2**14, device=where)
        t0 = time.perf_counter()
        res[where] = D.FBG(OpticalSignal(x.to(where)), fc=gv.f0,
                           vdneff=1e-4, kL=g["kL"], print_params=False,
                           retH=True)
        res[where + " s"] = time.perf_counter() - t0
    e_h = float(np.abs(res["cuda"][1] - res["cpu"][1]).max())
    yc, yh = res["cuda"][0].signal.cpu(), res["cpu"][0].signal
    e_y = float((yc - yh).abs().max() / yh.abs().max())
    check(e_h <= 1e-4 and e_y <= 1e-4, 20,
          f"FBG card vs CPU at 2^20: H off by {e_h:.3g}, output by {e_y:.3g} "
          f"of the peak (1e-4)")
    print(f"phase 20.2 FBG card vs CPU (2^20 samples): ok H to {e_h:.2g}, "
          f"output to {e_y:.2g} of the peak; card {res['cuda s']:.2f} s, CPU "
          f"{res['cpu s']:.2f} s", flush=True)
    del res, x, yc, yh

    # 20.4 the host eye engine on the chain's PD output
    gv(sps=SPS, R=R, wavelength=1550e-9, Vpi=5, N=N_BITS, device="cuda")
    fib = D.FIBER(mod, length=50, alpha=0.2, beta_2=-20, gamma=2)
    pdo = D.PD(fib, BW=0.75 * R, r=1, include_noise="all")
    del fib, mod, v
    walls = {}
    eyes = {}
    for engine in ("host", "device"):
        walls[engine] = []
        for _ in range(2):  # first and second call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eyes[engine] = D.GET_EYE(pdo, engine=engine)
            torch.cuda.synchronize()
            walls[engine].append(time.perf_counter() - t0)
    h, d = eyes["host"], eyes["device"]
    bad = [k for k in ("mu0", "mu1", "s0", "s1", "t_opt", "t_left",
                       "t_right", "er", "eye_h")
           if not abs(getattr(d, k) - getattr(h, k))
           <= 2e-4 * abs(getattr(h, k)) + 2e-5]
    plateau = max(h.threshold_plateau, d.threshold_plateau)
    thr_gap = abs(d.threshold - h.threshold)
    check(not bad and (thr_gap <= 2e-4 * abs(h.threshold) + 2e-5 or thr_gap
                       <= plateau + 2 * (h.mu1 - h.mu0) / 499), 20,
          f"GET_EYE host vs device: {bad} beyond 2e-4; threshold "
          f"{h.threshold} vs {d.threshold} (plateau {plateau:.3g})")
    print(f"phase 20.4 GET_EYE host vs device engine (2^24 samples): ok "
          f"mu0 {h.mu0:.6e} mu1 {h.mu1:.6e} s0 {h.s0:.6e} s1 {h.s1:.6e}, "
          f"threshold {h.threshold:.7f} vs {d.threshold:.7f} (plateau "
          f"{plateau:.3g}); wall host {walls['host'][0]:.3f}, "
          f"{walls['host'][1]:.3f} s, device {walls['device'][0]:.3f}, "
          f"{walls['device'][1]:.3f} s (first, second call)", flush=True)
    del pdo, eyes, h, d

    # 20.3 the trajectory of config 2's launch field
    gv(sps=SPS, R=R, N=N_BITS, device="cuda")
    b2b = link.build_link(dataclasses.replace(spec, stages=()), N_BITS,
                          params, device=dev, return_field=True)
    A0 = b2b.run(bits=prbs(15, length=N_BITS)[0]).field.contiguous()
    fib = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    z, A_z = D.FIBER(OpticalSignal(A0), return_steps=True, **fib)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    out["launches"]["trajectory"] = launches
    peak_mem = torch.cuda.max_memory_allocated()
    pin = PINNED_TRAJ
    steps = z.size - 1
    p_last = float(torch.view_as_real(A_z[-1]).double().square().sum(-1).max())
    check(steps == pin["n_steps"] and A_z.shape == (z.size, 2**24)
          and A_z.device.type == "cuda" and z[-1] == 50.0
          and abs(z[-2] - pin["z_last_start"]) <= Z_TOL_KM
          and abs(p_last - pin["max_power_last"])
          <= 1e-4 * pin["max_power_last"]
          and launches["nl_halfstep"] == steps
          and launches["cmul"] == 2 * steps, 20,
          f"trajectory: {steps} steps (JAX {pin['n_steps']}), last start "
          f"{z[-2]} (JAX {pin['z_last_start']}), last max|A|^2 {p_last} "
          f"(JAX {pin['max_power_last']}), frames {tuple(A_z.shape)} on "
          f"{A_z.device}, launches {launches}")
    print(f"phase 20.3 FIBER(return_steps=True) (2^24 samples, 50 km): ok "
          f"{steps} steps (JAX {pin['n_steps']}), last start {z[-2]:.9f} km "
          f"(JAX {pin['z_last_start']:.9f}), last max|A|^2 {p_last:.9g} W "
          f"(JAX {pin['max_power_last']:.9g}); {z.size} frames "
          f"{A_z.numel() * 8 / 2**30:.2f} GiB; wall {wall:.2f} s; peak "
          f"memory {peak_mem / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    del z, A_z, A0, b2b
    # the frames at 2^20 on the card against the CPU
    small = link.build_link(dataclasses.replace(spec, stages=()), SMALL_BITS,
                            params, device=dev, return_field=True)
    A1 = small.run(bits=prbs(15, length=SMALL_BITS)[0]).field.cpu()
    traj = {}
    for where in ("cuda", "cpu"):
        gv(sps=SPS, R=R, N=SMALL_BITS, device=where)
        traj[where] = D.FIBER(OpticalSignal(A1.to(where)), return_steps=True,
                              **fib)
    (zg, Ag), (zc, Ac) = traj["cuda"], traj["cpu"]
    check(zg.size == zc.size == pin["n_steps"] + 1, 20,
          f"trajectory at 2^20: {zg.size - 1} steps on the card, "
          f"{zc.size - 1} on the CPU")
    e_z = float(np.abs(zg - zc).max())
    e_a = float((Ag[-1].cpu() - Ac[-1]).abs().max() / Ac[-1].abs().max())
    check(e_z <= Z_TOL_KM and e_a <= 1e-4, 20,
          f"trajectory card vs CPU at 2^20: z off by {e_z:.3g} km, last "
          f"frame by {e_a:.3g} of the peak (1e-4)")
    print(f"phase 20.3 trajectory card vs CPU (2^20 samples): ok "
          f"{zg.size - 1} steps each, z to {e_z:.2g} km, last frame to "
          f"{e_a:.2g} of the peak; phase 20 {time.perf_counter() - t20:.1f} "
          f"s", flush=True)
    gv.default()
    return out


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
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.ops import _build, eyeana, kernels
    from opticomlib_tpu_torch.ops.prbs import prbs
    from opticomlib_tpu_torch.params import SimParams

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    libs = _build.build()  # one nvcc per source, started together
    for name in libs:
        _build.load_library(name)
    t_nvcc = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    :")[-1].strip()
             for path in libs.values()
             for ln in path.with_suffix(".log").read_text().splitlines()
             if "Used" in ln]
    t0 = time.perf_counter()
    a = torch.ones(8, dtype=torch.complex64, device=dev)
    kernels.cmul(*kernels.nl_halfstep(a, 0.1))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"phase 1 build: ok nvcc {t_nvcc:.2f} s ({', '.join(libs)}), "
          f"triton {t_triton:.2f} s; ptxas: {' | '.join(ptxas)}", flush=True)

    # ---- phase 2: each kernel against its plain version ----
    g = torch.Generator(device=dev).manual_seed(0)

    def field(*shape):
        # |A|^2 ~ 0.02 W, the slice's launch power
        return (torch.randn(shape, generator=g, device=dev,
                            dtype=torch.complex64) * 0.1).contiguous()

    coeff = 1.3 * 0.38553 / 2  # gamma * h0 / 2 of the slice's first step
    # fir_filter, the staged DAC's kernel, is checked in phase 8, and
    # fbg_rk4, the grating's, in phase 20
    err = {k: 0.0 for k in REPLACES if k not in ("fir_filter", "fbg_rk4")}
    # (2, 2^24) is config 4's 2-polarisation field, multiplied by one
    # 2^24 spectral row; the negative coefficient is how the Yoshida w0
    # substep and every DBP span kick
    # 2^24 + 2H is the padded block of the sharded fiber's overlap path at
    # h = 1 km (H = 109 samples a side at config 2's rate)
    from opticomlib_tpu_torch.parallel.halo import halo_width
    n_padded = 2**24 + 2 * halo_width(1.0, -21.0, 0.0, SPS * R)
    for shape in [(2**24,), (2**24 + 5,), (n_padded,), (2, 2**20),
                  (2, 2**24)]:
        A = field(*shape)
        E = field(shape[-1])
        for c in (coeff, -coeff):
            B, H = kernels.nl_halfstep(A, c)
            Br, Hr = kernels.nl_halfstep_ref(A, c)
            torch.testing.assert_close(B, Br, **TOL)
            torch.testing.assert_close(H, Hr, **TOL)
            err["nl_halfstep"] = max(err["nl_halfstep"], float(
                (B - Br).abs().max()), float((H - Hr).abs().max()))
            for other in (E, B):
                C, Cr = kernels.cmul(A, other), kernels.cmul_ref(A, other)
                # the kernel writes its rounding down as torch's complex
                # product rounds on the card: the same bits
                check(torch.equal(C, Cr), 2, f"cmul {shape} x "
                      f"{tuple(other.shape)} differs from A * B: max abs "
                      f"{float((C - Cr).abs().max()):.3g}")
                err["cmul"] = max(err["cmul"], float((C - Cr).abs().max()))
        del A, E, B, H, Br, Hr, C, Cr, other
    # cmul on views 8 bytes off a 16-byte boundary (the launcher's scalar
    # path), same-shape and broadcast, even and odd lengths, and once at the
    # full 2^24 (a block cut out of a padded buffer one sample in)
    for shape in [(2**20,), (2**20 + 1,), (2, 2**20), (2, 2**20 + 1),
                  (2**24,)]:
        for off_a, off_b in ((1, 0), (0, 1), (1, 1)):
            A = field(int(np.prod(shape)) + 1)[off_a:off_a + int(
                np.prod(shape))].reshape(shape)
            E = field(shape[-1] + 1)[off_b:off_b + shape[-1]]
            C, Cr = kernels.cmul(A, E), kernels.cmul_ref(A, E)
            check(torch.equal(C, Cr), 2, f"cmul {shape}, views offset "
                  f"({off_a}, {off_b}), differs from A * B: max abs "
                  f"{float((C - Cr).abs().max()):.3g}")
    del A, E, C, Cr
    # ---- the histograms: by rows and by pairs, every path of the launcher
    # The receiver's real input: the KDE bin indices of config 2's eye at
    # 2^20 samples (8192 slots resampled to 128 samples each), caught at the
    # wrapper the metrology calls.
    spec = config2_spec(link)
    params = SimParams.create(sps=SPS, R=R, _warn=False)
    v_small = link.build_link(spec, SMALL_BITS, params, device=dev).run(
        bits=prbs(15, length=SMALL_BITS)[0], seed=3).v.signal
    caught, rows_wrapper = [], kernels.histogram_rows
    kernels.histogram_rows = lambda yy, ny: (caught.append(yy)
                                             or rows_wrapper(yy, ny))
    try:
        m_small = eyeana.eye_metrics(v_small, sps=SPS, nslots=8192,
                                     sps_resamp=128)
    finally:
        kernels.histogram_rows = rows_wrapper
    eye_bins = caught[0]
    check(len(caught) == 1 and tuple(eye_bins.shape) == (1, 2**20), 2,
          f"the eye metrology launched {len(caught)} histograms of shape "
          f"{[tuple(c.shape) for c in caught]}")
    in_window = float((eye_bins >= 0).float().mean())

    def randbins(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def off_view(x, off):
        """``x``'s values in storage ``off`` int32 elements (4 bytes each)
        past an allocation's 16-byte boundary."""
        buf = torch.empty(x.numel() + off, dtype=x.dtype, device=dev)
        buf[off:] = x.reshape(-1)
        return buf[off:].reshape(x.shape)

    # 16 channels' windows (one real window, shifted a channel), every sample
    # of the waveform on 8192 amplitude bins (the range estimator's input),
    # and eye-like pairs for the (256, 256) density: uniform in time, two
    # levels in amplitude
    eye16 = torch.stack([torch.roll(eye_bins[0], 4099 * c) for c in range(16)])
    y_all = m_small["y"]
    amp = torch.clamp(((y_all - y_all.min()) / (y_all.max() - y_all.min())
                       * 8192).to(torch.int32), 0, 8191)
    amp16 = torch.stack([torch.roll(amp, 4099 * c) for c in range(16)])
    t22 = randbins((2**22,), 0, 256)
    y22 = (torch.where(torch.rand(2**22, generator=g, device=dev) > 0.5,
                       190.0, 60.0) + 6.0 * torch.randn(
                           2**22, generator=g, device=dev)).to(torch.int32)
    rows16 = torch.arange(16, device=dev, dtype=torch.int32).repeat_interleave(
        2**20)
    uni1, uni16 = randbins((1, 2**20), 0, 4096), randbins((16, 2**20), 0, 4096)

    rows_cases = {
        "(1, 4096) eye window": (eye_bins, 4096),
        "(1, 4096) uniform": (uni1, 4096),
        "(16, 4096) eye windows": (eye16, 4096),
        "(16, 4096) uniform": (uni16, 4096),
        "(16, 8192) amplitudes": (amp16, 8192),
        "(1, 4096) out of range on both sides": (
            randbins((1, 2**20), -3, 4099), 4096),
        "(3, 2^18 + 3): rows 4, 8, 12 bytes off": (
            randbins((3, 2**18 + 3), -1, 4097), 4096),
        "(2, 2^16) all masked": (
            torch.full((2, 2**16), -1, dtype=torch.int32, device=dev), 4096),
        "(2, 0) empty": (randbins((2, 0), 0, 16), 16),
        "(300, 1000): one block a row": (randbins((300, 1000), -1, 65), 64),
        "(1, 40000): three tiles": (randbins((1, 2**18), -1, 40_001), 40_000),
        "(2, 300000): the global path": (
            randbins((2, 2**16), -1, 300_001), 300_000),
    }
    for off in (1, 2, 3):
        rows_cases[f"(1, 4096) eye window, view {4 * off} bytes off"] = (
            off_view(eye_bins, off), 4096)
    pairs_cases = {
        "(1, 4096) with a row-index array": (
            torch.zeros_like(eye_bins[0]), eye_bins[0], 1, 4096),
        "(256, 256) 2^22 eye-like": (t22, y22, 256, 256),
        "(256, 256) 2^22 uniform": (randbins((2**22,), -1, 257),
                                    randbins((2**22,), -1, 257), 256, 256),
        "(16, 8192) 16 x 2^20": (rows16, amp16.reshape(-1), 16, 8192),
        "(1024, 1024) 2^20: the global path": (
            randbins((2**20,), -1, 1025), randbins((2**20,), -1, 1025),
            1024, 1024),
        "(64, 256) 2^20 + 1": (randbins((2**20 + 1,), -1, 65),
                               randbins((2**20 + 1,), -1, 257), 64, 256),
        "(256, 256) all masked": (t22, torch.full_like(y22, -1), 256, 256),
        "(512, 512) empty": (randbins((0,), 0, 9), randbins((0,), 0, 9),
                             512, 512),
    }
    for off_t, off_y in ((1, 1), (2, 2), (3, 3), (0, 1), (2, 0)):
        pairs_cases[f"(256, 256), views {4 * off_t} and {4 * off_y} bytes "
                    "off"] = (off_view(t22[:2**20 + 1], off_t),
                              off_view(y22[:2**20 + 1], off_y), 256, 256)
    for label, (yy, ny) in rows_cases.items():
        for again in range(2):  # the second launch finds the scratch zero
            h = kernels.histogram_rows(yy, ny)
            check(torch.equal(h, kernels.histogram_rows_ref(yy, ny)), 2,
                  f"histogram_rows {label} (launch {again + 1}): counts "
                  "differ from the plain version")
    for label, (tt, yy, nt, ny) in pairs_cases.items():
        for again in range(2):
            h = kernels.histogram2d(tt, yy, nt, ny)
            check(torch.equal(h, kernels.histogram2d_ref(tt, yy, nt, ny)), 2,
                  f"histogram2d {label} (launch {again + 1}): counts differ "
                  "from the plain version")
    torch.cuda.synchronize()
    n_hist_cases = len(rows_cases) + len(pairs_cases)
    # the nearest library calls: bincount alone takes no masked (-1) sample
    # and histc only floats, so neither computes the function on the eye
    # window in one call; on in-range bins bincount does
    check(torch.equal(torch.bincount(uni1[0], minlength=4096).to(
        torch.float32), kernels.histogram_rows(uni1, 4096)[0]), 2,
        "bincount differs on in-range bins")
    eye_f32 = eye_bins[0].to(torch.float32)
    check(torch.equal(torch.histc(eye_f32, bins=4096, min=0, max=4096),
                      kernels.histogram_rows(eye_bins, 4096)[0]), 2,
          "histc on the float copy differs")
    hist_timed = {k: rows_cases[k] for k in list(rows_cases)[:5]}
    hist_timed.update({k: pairs_cases[k] for k in list(pairs_cases)[:5]})

    # adc_quantize, link mode, as config 4 runs it: a PD-like voltage at
    # 2^24 samples, lo/hi the 99.99 % range left on the card
    lv = torch.where(torch.rand(2**24, generator=g, device=dev) > 0.5,
                     0.24, 0.017)
    v = (lv + 0.012 * torch.randn(2**24, generator=g, device=dev)).to(
        torch.float32)
    lo, hi = eyeana._shortest_int_masked(
        v, torch.ones_like(v, dtype=torch.bool), 99.99)
    nq = 2.0 ** 8 - 1
    y, yr = (kernels.adc_quantize_link(v, lo, hi, 8),
             kernels.adc_quantize_link_ref(v, lo, hi, 8))
    codes = torch.round((y - lo) / (hi - lo) * nq)
    check(torch.equal(codes, torch.round((yr - lo) / (hi - lo) * nq))
          and torch.equal(y, yr), 2, "adc_quantize (link) differs from "
          f"plain at {int((y != yr).sum())} samples")
    outside = int(((codes < 0) | (codes > nq)).sum())
    # kernel mode: exact half-step ties on a unit step round half up
    x = (torch.arange(2**24, device=dev) % 255).to(torch.float32) + 0.5
    yk = kernels.adc_quantize(x, 0.0, 255.0, 8)
    check(torch.equal(yk, kernels.adc_quantize_ref(x, 0.0, 255.0, 8))
          and torch.equal(yk, x + 0.5), 2,
          "adc_quantize (kernel mode) ties not rounded half up")
    # stochastic: on the grid, unbiased, every 65,536-sample block its own
    xs = torch.full((2**24,), 0.30, device=dev)
    ys = kernels.adc_quantize(xs, 0.0, 1.0, 2, stochastic=True, seed=3)
    q = ys * 3.0
    # 0.3 is 0.9 of a step: the level above w.p. 0.9, the one below w.p. 0.1
    dither_sigma = (1 / 3) * np.sqrt(0.9 * 0.1 / xs.numel())
    bias = abs(float(ys.double().mean()) - 0.30)
    check(float((q - torch.round(q)).abs().max()) < 1e-4
          and bias < 3 * dither_sigma
          and not torch.equal(ys[:65536], ys[65536:131072]), 2,
          f"adc_quantize (stochastic): mean off by {bias:.3g} "
          f"(3 sigma {3 * dither_sigma:.3g}) or off grid or repeating")
    err["adc_quantize"] = float((y - yr).abs().max())

    A, E, A2 = field(2**24), field(2**24), field(2, 2**24)
    pairs = {
        "nl_halfstep": (lambda: kernels.nl_halfstep(A, coeff),
                        lambda: kernels.nl_halfstep_ref(A, coeff)),
        "cmul": (lambda: kernels.cmul(A, E), lambda: kernels.cmul_ref(A, E)),
        # config 4's shape: the 2-polarisation field times one spectral row
        "cmul_2pol": (lambda: kernels.cmul(A2, E),
                      lambda: kernels.cmul_ref(A2, E)),
        # the main paths' call: one receiver's eye window by rows
        "histogram2d": (
            lambda: kernels.histogram_rows(eye_bins, 4096),
            lambda: kernels.histogram_rows_ref(eye_bins, 4096)),
        "adc_quantize": (
            lambda: kernels.adc_quantize_link(v, lo, hi, 8),
            lambda: kernels.adc_quantize_link_ref(v, lo, hi, 8)),
    }
    # ms: one launch between two events (the earlier records' figure); ms10:
    # ten launches in a row, as the paths queue them
    ms, ms10 = {}, {}
    for k, fns in pairs.items():
        ms[k], ms10[k] = timed(torch, *fns)
    ms_adc_kernel_mode = (
        cuda_ms(torch, lambda: kernels.adc_quantize(v, 0.0, 0.3, 8)),
        cuda_ms(torch, lambda: kernels.adc_quantize_ref(v, 0.0, 0.3, 8)))
    # one PyTorch call for the same function, timed beside the kernel and
    # used nowhere in the port: torch.mul for cmul (nl_halfstep's plain
    # version is four passes, the ADC's five; bincount takes no masked
    # sample and histc no integers, so the eye window's histogram has no
    # single call and null, and the in-range uniform bins have bincount)
    library = {"cmul": cuda_ms(torch, lambda: torch.mul(A, E), inner=10),
               "cmul_2pol": cuda_ms(torch, lambda: torch.mul(A2, E),
                                    inner=10)}
    # Bounds, from the bytes each function must move (inputs read once,
    # outputs written once) and its float32 operations at these shapes:
    #   nl_halfstep  8 B read + 16 B written a sample; |A|^2 * c (4), cos
    #                and sin (counted 1 each), the rotation (6): 12 flop
    #   cmul         16 B + 8 B a sample (same shape), 6 flop; 2-pol: A and
    #                C at 2 x 8 B a column and the row once
    #   histogram2d  by rows: 4 B a sample + the (1, 4096) float32 counts;
    #                one add a sample
    #   adc_quantize 4 B + 4 B a sample; 6 flop (sub, div, mul, round, div,
    #                fma-free mul and add)
    n24 = 2**24
    bounds = {"nl_halfstep": bound_ms(24 * n24, 12 * n24),
              "cmul": bound_ms(24 * n24, 6 * n24),
              "cmul_2pol": bound_ms((2 * 16 + 8) * n24, 2 * 6 * n24),
              "histogram2d": bound_ms(4 * 2**20 + 4 * 4096, 2**20),
              "adc_quantize": bound_ms(8 * n24, 6 * n24)}
    # the histograms' other shapes, each with its bound: 4 B a sample by
    # rows, 8 B a pair, the float32 table written once; one add a sample
    hist_also = {}
    for label, case in hist_timed.items():
        if label == "(1, 4096) eye window":
            continue
        key = "hist " + label
        by_rows = len(case) == 2
        fns = ((lambda c=case: kernels.histogram_rows(*c),
                lambda c=case: kernels.histogram_rows_ref(*c)) if by_rows
               else (lambda c=case: kernels.histogram2d(*c),
                     lambda c=case: kernels.histogram2d_ref(*c)))
        ms[key], ms10[key] = timed(torch, *fns, reps=10)
        n_el = case[-3 if not by_rows else 0].numel()
        table = (case[0].shape[0] * case[1] if by_rows
                 else case[2] * case[3])
        bounds[key] = bound_ms((4 if by_rows else 8) * n_el + 4 * table, n_el)
        err[key] = 0.0
        hist_also[key] = ("by rows " if by_rows else "by pairs ") + label
    ms_histc = cuda_ms(torch, lambda: torch.histc(
        eye_f32, bins=4096, min=0, max=4096), inner=10)
    library["hist (1, 4096) uniform"] = cuda_ms(
        torch, lambda: torch.bincount(uni1[0], minlength=4096), inner=10)
    bytes_per = {"nl_halfstep": 24, "cmul": 24, "cmul_2pol": 40,
                 "adc_quantize": 8}
    gbs = {k: b * 2**24 / (ms10[k][0] * 1e-3) / 1e9
           for k, b in bytes_per.items()}
    err["cmul_2pol"] = err["cmul"]
    print("phase 2 kernels: ok " + "; ".join(
        f"{k} max_abs_err {err[k]:.3g}, {ms[k][0]:.4f} ms vs plain "
        f"{ms[k][1]:.4f} ms one launch at a time, {ms10[k][0]:.4f} vs "
        f"{ms10[k][1]:.4f} ms queued"
        + (f" ({gbs[k]:.0f} GB/s)" if k in gbs else "")
        + f", bound {bounds[k][0]:.4f} ms"
        + (f", one torch call {library[k]:.4f} ms" if k in library else "")
        for k in err) + f"; adc_quantize link mode bit-exact with "
        f"{outside} samples outside the range extrapolated, kernel mode "
        f"{ms_adc_kernel_mode[0]:.4f} ms vs plain {ms_adc_kernel_mode[1]:.4f}"
        f" ms, stochastic mean off by {bias / dither_sigma:.2f} sigma; "
        f"histograms exact at {n_hist_cases} shapes and views, twice each "
        f"({in_window:.1%} of the eye window's samples unmasked); histc on a "
        f"float copy of the eye window {ms_histc:.4f} ms queued",
        flush=True)
    for k in hist_also:
        del err[k]
    del A, E, A2, v, y, yr, codes, x, yk, xs, ys, q, err["cmul_2pol"]
    del eye16, amp16, t22, y22, rows16, uni16, rows_cases, pairs_cases
    del hist_timed, caught, v_small, m_small, y_all, amp

    # ---- phase 3: config 2, card vs CPU on the same noise, 2^20 samples ----
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
        res[name] = (run.v.to_numpy(), run.n_steps,
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
    print(f"phase 3 config 2 card-vs-cpu (2^20 samples): ok n_steps {st_g}, "
          f"v rel L2 {rel:.3g}, n_errors {d_g.n_errors}, threshold "
          f"{d_g.threshold:.6f} vs {d_c.threshold:.6f}", flush=True)

    # ---- phase 4: config 2 at full size through the kernels ----
    prog = link.build_link(spec, N_BITS, params, device=dev)
    bits = prbs(15, length=N_BITS)[0]
    d, launches2, t_first, walls, peak = timed_dsp(torch, kernels, prog,
                                                   bits)
    unsharded_walls = {"config2": (t_first, walls)}  # beside phase 18's
    e = d.eye
    check(d.n_steps == (PINNED["n_steps"],), 4,
          f"n_steps {d.n_steps} != ({PINNED['n_steps']},)")
    check(launches2["nl_halfstep"] >= 58 and launches2["cmul"] >= 116
          and launches2["histogram2d"] >= 1, 4, f"launches {launches2}")
    hold_to_pin(d, PINNED, 4)
    print(f"phase 4 config 2 (2^24 samples): ok n_steps {d.n_steps[0]}, BER "
          f"{d.ber} ({d.n_errors} errors), threshold {d.threshold:.5f} "
          f"(JAX {PINNED['threshold']}), mu0 {e.mu0:.5f} mu1 {e.mu1:.5f} "
          f"s0 {e.s0:.5f} s1 {e.s1:.5f}; launches {launches2}; wall first "
          f"{t_first:.3f} s, then {', '.join(f'{w:.3f}' for w in walls)} s; "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    del prog, d

    # ---- phase 5: config 4, card vs CPU on the same noise, 2^20 samples ----
    spec4 = config4_spec(link)
    params4 = SimParams.create(sps=SPS4, R=R, _warn=False)
    n = SMALL_BITS4 * SPS4
    rng = np.random.default_rng(8)
    noise = {"phase": rng.standard_normal(n, dtype=np.float32),
             "rin": rng.standard_normal(n, dtype=np.float32),
             "ase": [rng.standard_normal((4, n), dtype=np.float32)
                     for _ in range(20)],
             "thermal": rng.standard_normal(n, dtype=np.float32),
             "shot": rng.standard_normal(n, dtype=np.float32)}
    bits = prbs(15, length=SMALL_BITS4)[0]
    # the chain without its ADC, so the voltage itself can be compared; the
    # ADC and receiver of dsp() then run on each device's voltage
    unquantised = dataclasses.replace(spec4, adc_bits=None)
    res = {}
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        prog = link.build_link(unquantised, SMALL_BITS4, params4, device=name)
        run = prog.run(bits=bits, noise=noise)
        vq = link._adc_quantize(run.v.signal, spec4.adc_bits)
        bits_f32 = torch.as_tensor(bits.astype(np.float32), device=name)
        m, rth, n_err = link._ook_rx_ingraph(vq, vq[prog.instant::SPS4],
                                             bits_f32, SPS4, 8192, 128)
        res[name] = dict(v=run.v.to_numpy(), vq=vq.cpu().numpy(),
                         steps=run.n_steps, n_err=int(n_err), th=float(rth),
                         eye=float(m["mu1"] - m["mu0"]), ok=run.rin_ok,
                         s=time.perf_counter() - t0)
    r_g, r_c = res["cuda"], res["cpu"]
    rel = float(np.linalg.norm(r_g["v"] - r_c["v"]) / np.linalg.norm(r_c["v"]))
    rel_q = float(np.linalg.norm(r_g["vq"] - r_c["vq"])
                  / np.linalg.norm(r_c["vq"]))
    # each device quantises on its own range (lo, hi shift with the
    # voltage's round-off), so a level moves a little everywhere; a code
    # moves where a level moves by about a whole step
    level = np.diff(np.unique(r_c["vq"])).min()
    moved = np.abs(r_g["vq"] - r_c["vq"]) > 0.5 * level
    scan_step = abs(r_c["eye"]) / 999
    check(r_g["steps"] == r_c["steps"] and len(r_g["steps"]) == 40, 5,
          f"n_steps card {r_g['steps']} vs CPU {r_c['steps']}")
    check(rel <= 1e-3, 5, f"v rel L2 {rel:.3g} > 1e-3")
    check(moved.mean() <= 0.05 and np.abs(r_g["vq"] - r_c["vq"]).max()
          <= 1.5 * level, 5, f"ADC codes moved at {moved.mean():.3%} of "
          f"the samples, or by more than one level (v rel L2 {rel:.3g})")
    check(r_g["n_err"] == r_c["n_err"], 5,
          f"n_errors card {r_g['n_err']} vs CPU {r_c['n_err']}")
    check(abs(r_g["th"] - r_c["th"]) <= scan_step * (1 + 1e-3), 5,
          f"threshold card {r_g['th']} vs CPU {r_c['th']}")
    check(r_g["ok"] and r_c["ok"], 5, "a RIN draw was clamped")
    print(f"phase 5 config 4 card-vs-cpu (2^20 samples): ok n_steps "
          f"{sum(r_g['steps'])} in 40 spans, v rel L2 {rel:.3g} before the "
          f"ADC and {rel_q:.3g} after it ({moved.mean():.3%} of the codes "
          f"one level apart), n_errors {r_g['n_err']}, threshold "
          f"{r_g['th']:.6f} vs {r_c['th']:.6f}; card {r_g['s']:.1f} s, CPU "
          f"{r_c['s']:.1f} s", flush=True)
    del prog, run, vq, noise

    # ---- phase 6: config 4 at full size through the kernels ----
    prog = link.build_link(spec4, N_BITS4, params4, device=dev)
    bits = prbs(15, length=N_BITS4)[0]
    d, launches4, t_first, walls, peak = timed_dsp(torch, kernels, prog,
                                                   bits)
    unsharded_walls["config4"] = (t_first, walls)
    e = d.eye
    check(d.n_steps == (4,) * 40, 6, f"n_steps {d.n_steps}")
    check(launches4["nl_halfstep"] >= 960 and launches4["cmul"] >= 480
          and launches4["histogram2d"] >= 1
          and launches4["adc_quantize"] >= 1, 6, f"launches {launches4}")
    check(d.rin_ok, 6, "a RIN draw was clamped")
    hold_to_pin(d, PINNED4, 6)
    print(f"phase 6 config 4 (2^24 samples): ok {sum(d.n_steps)} o4 steps, "
          f"BER {d.ber} ({d.n_errors} errors), threshold {d.threshold:.6f} "
          f"(JAX {PINNED4['threshold']}), mu0 {e.mu0:.6f} mu1 {e.mu1:.6f} "
          f"s0 {e.s0:.6f} s1 {e.s1:.6f}; launches {launches4}; wall first "
          f"{t_first:.3f} s, then {', '.join(f'{w:.3f}' for w in walls)} s; "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    del prog, d

    # ---- phase 7: the noiseless 40 spans undo themselves ----
    fields = []
    quiet = config4_spec(link, noisy=False)
    for sp in (quiet, dataclasses.replace(quiet, stages=())):
        prog = link.build_link(sp, N_BITS4, params4, device=dev,
                               return_field=True)
        fields.append(prog.run(bits=bits).field)
        del prog
    rt = float(torch.linalg.vector_norm(fields[0] - fields[1])
               / torch.linalg.vector_norm(fields[1]))
    check(rt <= 0.01, 7, f"round-trip rel L2 {rt:.3g} > 0.01")
    print(f"phase 7 config 4 noiseless round trip (2^24 samples): ok rel L2 "
          f"{rt:.3g} (JAX at 2^20 samples {PINNED4['round_trip']:.3g}; "
          "target 0.01)", flush=True)
    del fields

    # ---- phase 8: fir_filter against its plain version ----
    from opticomlib_tpu_torch.ops import pulses
    taps = {"gaussian": pulses.fir_taps(pulses.gauss_pulse(60, SPS).real)[0],
            "nrz": pulses.fir_taps(pulses.nrz_pulse(60, SPS))[0]}
    check(taps["gaussian"].size == 783 and taps["nrz"].size == 64, 8,
          f"DAC taps {[h.size for h in taps.values()]}, expected 783 and 64")
    err["fir_filter"] = 0.0
    fir_ms, fir_ms10 = {}, {}
    rng8 = np.random.default_rng(0)
    for n, h in [(2**24, taps["gaussian"]), (2**24, taps["nrz"]),
                 (2**20 + 3, taps["gaussian"]),
                 (100_003, rng8.normal(size=4097))] + [
                     (2**20 + 3, rng8.normal(size=k))
                     for k in (1, 7, 8, 9, kernels.FIR_MAX_TAPS)]:
        x = torch.randn(n, generator=g, device=dev)
        hh = torch.as_tensor(h, dtype=torch.float32, device=dev)
        y, yr = kernels.fir_filter(x, hh), kernels.fir_filter_ref(x, hh)
        e = float((y - yr).abs().max())
        bound = 1e-5 * float(yr.abs().max())
        check(e <= bound, 8, f"fir_filter ({n}, {h.size} taps) max abs err "
              f"{e:.3g} > {bound:.3g}")
        err["fir_filter"] = max(err["fir_filter"], e)
        if n == 2**24:
            x64 = x.double()
            # the one PyTorch call for the same function: conv1d alone, on
            # an input padded and taps flipped beforehand, TF32 off as in
            # the plain version
            xp = torch.nn.functional.pad(x.reshape(1, 1, -1), (h.size - 1, 0))
            w = torch.flip(hh, (0,)).reshape(1, 1, -1)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            t_conv = cuda_ms(
                torch, lambda: torch.nn.functional.conv1d(xp, w), inner=10)
            torch.backends.cudnn.allow_tf32 = tf32
            single, queued = timed(
                torch, lambda: kernels.fir_filter(x, hh),
                lambda: kernels.fir_filter_ref(x, hh),
                lambda: pulses._fft_same(x64, h, h.size, 0))
            fir_ms[h.size] = (*single, t_conv)
            fir_ms10[h.size] = queued
            del xp, w
        del x, y, yr
    del x64
    ms["fir_filter"], ms10["fir_filter"] = fir_ms[783][:2], fir_ms10[783][:2]
    ms["fir_filter_64"], ms10["fir_filter_64"] = (fir_ms[64][:2],
                                                  fir_ms10[64][:2])
    library["fir_filter"], library["fir_filter_64"] = (fir_ms[783][3],
                                                       fir_ms[64][3])
    # 4 B read and 4 B written a sample and the taps once; one FMA (two
    # operations) a sample and tap: the operations bound at 783 taps, the
    # bytes at 64
    bounds["fir_filter"] = bound_ms(8 * n24 + 4 * 783, 2 * 783 * n24)
    bounds["fir_filter_64"] = bound_ms(8 * n24 + 4 * 64, 2 * 64 * n24)
    print("phase 8 fir_filter: ok max_abs_err " + f"{err['fir_filter']:.3g} "
          "(bound 1e-5 x max|y|); at 2^24 samples " + "; ".join(
              f"{k} taps {t[0]:.4f} ms vs plain (pad, flip, conv1d) "
              f"{t[1]:.4f} ms vs float64 FFT convolution {t[2]:.4f} ms one "
              f"launch at a time, {fir_ms10[k][0]:.4f} vs {fir_ms10[k][1]:.4f}"
              f" vs {fir_ms10[k][2]:.4f} ms queued "
              f"({k * 2**24 / fir_ms10[k][0] / 1e9:.2f} T FMA/s), conv1d "
              f"alone {t[3]:.4f} ms" for k, t in fir_ms.items())
          + f"; bound {bounds['fir_filter'][0]:.4f} ms at 783 taps "
          f"({bounds['fir_filter'][1]}), {bounds['fir_filter_64'][0]:.4f} ms "
          f"at 64 ({bounds['fir_filter_64'][1]})", flush=True)

    # ---- phase 9: the staged chain, card vs CPU on the same noise ----
    res = {}
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[name] = staged_chain(torch, SMALL_BITS_STAGED, name, np_seed=7)
        res[name]["s"] = time.perf_counter() - t0
    r_g, r_c = res["cuda"], res["cpu"]
    rel = float(np.linalg.norm(r_g["v"] - r_c["v"]) / np.linalg.norm(r_c["v"]))
    scan_step = abs(r_c["eye"].mu1 - r_c["eye"].mu0) / 999
    check(r_g["n_steps"] == r_c["n_steps"], 9,
          f"n_steps card {r_g['n_steps']} vs CPU {r_c['n_steps']}")
    check(rel <= 1e-4, 9, f"v rel L2 {rel:.3g} > 1e-4")
    check(r_g["n_err"] == r_c["n_err"], 9,
          f"n_errors card {r_g['n_err']} vs CPU {r_c['n_err']}")
    check(abs(r_g["threshold"] - r_c["threshold"]) <= 2 * scan_step, 9,
          f"threshold card {r_g['threshold']} vs CPU {r_c['threshold']}")
    print(f"phase 9 staged chain card-vs-cpu (2^20 samples): ok n_steps "
          f"{r_g['n_steps']}, v rel L2 {rel:.3g}, n_errors {r_g['n_err']}, "
          f"threshold {r_g['threshold']:.7f} vs {r_c['threshold']:.7f}; card "
          f"{r_g['s']:.1f} s, CPU {r_c['s']:.1f} s", flush=True)
    del res, r_g, r_c

    # ---- phase 10: the staged chain at full size through the kernels ----
    pin = PINNED_STAGED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    d = staged_chain(torch, N_BITS, "cuda", np_seed=pin["seed"], timed=True)
    launches_staged = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    e = d["eye"]
    check(all(launches_staged[k] > 0 for k in ("fir_filter", "nl_halfstep",
                                                "cmul", "histogram2d")), 10,
          f"launches {launches_staged}")
    check(d["n_steps"] == pin["n_steps"], 10,
          f"n_steps {d['n_steps']} != JAX {pin['n_steps']}")
    check(d["ber"] == pin["ber"], 10, f"BER {d['ber']} != JAX {pin['ber']}")
    step = abs(pin["mu1"] - pin["mu0"]) / 999
    check(abs(d["threshold"] - pin["threshold"]) <= 2 * step, 10,
          f"threshold {d['threshold']} vs JAX {pin['threshold']} "
          f"(2 grid steps {2 * step:.3g})")
    for k in ("mu0", "mu1", "s0", "s1"):
        check(abs(getattr(e, k) - pin[k]) <= 1e-3 * abs(pin[k]), 10,
              f"{k} {getattr(e, k)} vs JAX {pin[k]} (1e-3 relative)")
    steady = staged_chain(torch, N_BITS, "cuda", np_seed=pin["seed"],
                          timed=True)
    check(steady["n_err"] == d["n_err"], 10, "the steady run differs")
    fmt = lambda w: ", ".join(f"{k} {v * 1e3:.1f}" for k, v in w.items())
    print(f"phase 10 staged chain (2^24 samples): ok n_steps {d['n_steps']}, "
          f"BER {d['ber']} ({d['n_err']} errors), threshold "
          f"{d['threshold']:.7f} (JAX {pin['threshold']:.7f}), mu0 "
          f"{e.mu0:.6e} mu1 {e.mu1:.6e} s0 {e.s0:.6e} s1 {e.s1:.6e}; "
          f"launches {launches_staged}; peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    print(f"phase 10 wall ms, first run: {fmt(d['walls'])}", flush=True)
    print(f"phase 10 wall ms, second run: {fmt(steady['walls'])}", flush=True)
    keyed = staged_chain(torch, N_BITS, None, gv_seed=11)  # no device named
    check(keyed["device"] == "cuda", 10,
          f"with no device named the chain ran on {keyed['device']}")
    hold_to_pin(SimpleNamespace(eye=keyed["eye"], ber=keyed["ber"],
                                threshold=keyed["threshold"]), pin, 10)
    check(keyed["n_steps"] == pin["n_steps"], 10,
          f"keyed n_steps {keyed['n_steps']}")
    print(f"phase 10 staged chain, gv(seed=11) noise, no device named (ran "
          f"on {keyed['device']}): ok BER {keyed['ber']}, "
          f"threshold {keyed['threshold']:.7f}, mu0 {keyed['eye'].mu0:.6e} "
          f"mu1 {keyed['eye'].mu1:.6e} s0 {keyed['eye'].s0:.6e} s1 "
          f"{keyed['eye'].s1:.6e}", flush=True)
    del d, steady, keyed

    # ---- phase 11: config 3, card vs CPU on the same draws, 2^20 samples ----
    spec3 = config3_spec(link)
    params3 = SimParams.create(sps=SPS3, R=R, _warn=False)
    n = SMALL_SYM3 * M3 * SPS3
    rng = np.random.default_rng(9)
    noise = {"ase": [], "thermal": rng.standard_normal(n, dtype=np.float32),
             "shot": rng.standard_normal(n, dtype=np.float32),
             "hdd": rng.random((SMALL_SYM3, M3), dtype=np.float32)}
    bits = prbs(15, length=SMALL_SYM3 * 3)[0]
    res = {}
    for name in ("cuda", "cpu"):
        prog = link.build_link(spec3, SMALL_SYM3 * M3, params3, device=name)
        res[name] = {dec: prog.dsp_ppm(M3, decision=dec, bits=bits,
                                       noise=noise)
                     for dec in ("soft", "hard")}
    for dec in ("soft", "hard"):
        d_g, d_c = res["cuda"][dec], res["cpu"][dec]
        check(d_g.n_steps == d_c.n_steps, 11,
              f"{dec}: n_steps card {d_g.n_steps} vs CPU {d_c.n_steps}")
        check(d_g.n_errors == d_c.n_errors, 11,
              f"{dec}: n_errors card {d_g.n_errors} vs CPU {d_c.n_errors}")
    h_g, h_c = res["cuda"]["hard"], res["cpu"]["hard"]
    kde_step = abs(h_c.eye.mu1 - h_c.eye.mu0) / 499
    plateau = max(h_g.eye.threshold_plateau, h_c.eye.threshold_plateau)
    check(abs(h_g.threshold - h_c.threshold) <= 2 * kde_step + plateau, 11,
          f"threshold card {h_g.threshold} vs CPU {h_c.threshold} (2 grid "
          f"steps {2 * kde_step:.3g}, flat stretch {plateau:.3g})")
    # the two voltages agree to about 1e-5 of the ON level (phase 3), and a
    # spread here is a few thousandths of it
    for k in ("mu0", "mu1", "s0", "s1"):
        check(abs(getattr(h_g.eye, k) - getattr(h_c.eye, k))
              <= 1e-4 * abs(getattr(h_c.eye, k)) + 1e-5 * h_c.eye.mu1, 11,
              f"{k} card {getattr(h_g.eye, k)} vs CPU {getattr(h_c.eye, k)}")
    print(f"phase 11 config 3 card-vs-cpu (2^20 samples): ok n_steps "
          f"{h_g.n_steps}, n_errors soft {res['cuda']['soft'].n_errors} hard "
          f"{h_g.n_errors} (equal), threshold {h_g.threshold:.6f} vs "
          f"{h_c.threshold:.6f} (grid step {kde_step:.3g}, flat stretch "
          f"{plateau:.3g}), mu1 {h_g.eye.mu1:.6f} vs {h_c.eye.mu1:.6f}",
          flush=True)
    del res, prog, noise

    # ---- phase 12: config 3 at full size through the kernels ----
    prog3 = link.build_link(spec3, N_SYM3 * M3, params3, device=dev)
    bits = prbs(15, length=N_SYM3 * 3)[0]
    d_s, launches3s, t_first_s, walls_s, peak_s = timed_call(
        torch, kernels, lambda: prog3.dsp_ppm(M3, decision="soft", bits=bits,
                                              seed=3), steady=2)
    d_h, launches3, t_first_h, walls_h, peak_h = timed_call(
        torch, kernels, lambda: prog3.dsp_ppm(M3, decision="hard", bits=bits,
                                              seed=3), steady=2)
    steps3 = d_h.n_steps[0]
    check(d_s.n_steps == d_h.n_steps and steps3 > 1, 12,
          f"n_steps soft {d_s.n_steps} hard {d_h.n_steps}")
    check(launches3["nl_halfstep"] >= steps3
          and launches3["cmul"] >= 2 * steps3
          and launches3["histogram2d"] == 1
          and launches3s["histogram2d"] == 0
          and launches3s["nl_halfstep"] >= steps3, 12,
          f"launches hard {launches3} soft {launches3s}")
    check(d_s.ber <= 1e-4, 12, f"soft BER {d_s.ber}")
    e = d_h.eye
    hold_to_pin(d_h, PINNED3, 12, slots=(7168, 1024), rel_floor=1e-3,
                threshold_slack=e.threshold_plateau)
    check(e.mu0 + 3 * e.s0 < d_h.threshold < e.mu1 - 3 * e.s1, 12,
          f"threshold {d_h.threshold} not inside the eye opening")
    print(f"phase 12 config 3 (2^24 samples, M = 8): ok n_steps {steps3}, "
          f"soft BER {d_s.ber} ({d_s.n_errors} errors), hard BER {d_h.ber} "
          f"({d_h.n_errors} errors), threshold {d_h.threshold:.6f} (JAX "
          f"{PINNED3['threshold']}, flat stretch {e.threshold_plateau:.3g}), "
          f"mu0 {e.mu0:.6f} mu1 {e.mu1:.6f} s0 {e.s0:.6f} s1 {e.s1:.6f}; "
          f"launches hard {launches3}; wall soft first {t_first_s:.3f} s, "
          f"then {', '.join(f'{w:.3f}' for w in walls_s)} s; hard first "
          f"{t_first_h:.3f} s, then {', '.join(f'{w:.3f}' for w in walls_h)} "
          f"s; peak memory {max(peak_s, peak_h) / 2**30:.2f} GiB", flush=True)
    del prog3, d_s, d_h

    # ---- phase 13: config 5, the 16-channel sweep ----
    params5 = SimParams.create(sps=SPS5, R=R, _warn=False)

    def bits5(n_bits):
        return prbs(23, length=N_CH5 * n_bits)[0].reshape(N_CH5, n_bits)

    prog = link.build_link(spec, SMALL_BITS5, params5, device=dev)
    bits = bits5(SMALL_BITS5)
    kernels.reset_launches()
    sw = prog.dsp_wdm(N_CH5, bits=bits, seed=5)
    check(kernels.LAUNCHES["histogram2d"] == 1, 13,
          f"the sweep launched {kernels.LAUNCHES['histogram2d']} histograms")
    for c in range(N_CH5):
        d = prog.dsp(bits=bits[c], seed=5 + c, sps_resamp=None)
        check(sw.n_errors[c] == d.n_errors and sw.n_steps[c] == d.n_steps, 13,
              f"channel {c}: sweep {sw.n_errors[c]} errors, {sw.n_steps[c]} "
              f"steps; dsp(seed={5 + c}) {d.n_errors}, {d.n_steps}")
        check(abs(sw.threshold[c] - d.threshold) <= 1e-6 * abs(d.threshold),
              13, f"channel {c}: threshold {sw.threshold[c]} vs {d.threshold}")
        for k in ("mu0", "mu1", "s0", "s1"):
            check(abs(getattr(sw, k)[c] - getattr(d.eye, k))
                  <= 1e-5 * abs(getattr(d.eye, k)), 13,
                  f"channel {c}: {k} {getattr(sw, k)[c]} vs "
                  f"{getattr(d.eye, k)}")
    print(f"phase 13 config 5 sweep vs 16 dsp calls (2^20 samples a "
          f"channel): ok n_errors {sw.n_errors.tolist()}, steps "
          f"{[st[0] for st in sw.n_steps]}, thresholds "
          f"{float(sw.threshold.min()):.5f}-{float(sw.threshold.max()):.5f}, "
          "one histogram launch", flush=True)
    del prog

    def sweep5(n_bits, steady):
        prog = link.build_link(spec, n_bits, params5, device=dev)
        bits = bits5(n_bits)
        out = timed_call(torch, kernels, lambda: prog.dsp_wdm(
            N_CH5, bits=bits, seed=5), steady=steady)
        sw = out[0]
        check(out[1]["histogram2d"] == 1
              and out[1]["nl_halfstep"] >= sum(st[0] for st in sw.n_steps)
              and out[1]["cmul"] >= 2 * sum(st[0] for st in sw.n_steps), 13,
              f"launches of one sweep {out[1]}")
        check(sw.rin_ok.all(), 13, "a RIN draw was clamped")
        check(float(sw.ber.max()) <= 1e-4, 13, f"BER {sw.ber}")
        for k, spread in PINNED5_STD.items():
            off = np.abs(getattr(sw, k) - PINNED5[k]) / spread
            check(off.max() <= 5, 13,
                  f"channel {int(off.argmax())}: {k} "
                  f"{getattr(sw, k)[off.argmax()]} is {off.max():.1f} "
                  f"deviations from the JAX mean {PINNED5[k]} +- {spread}")
        return out

    sw, launches5, t_first, walls, peak = sweep5(N_BITS5, steady=1)
    sw5, unsharded_walls["config5"] = sw, (t_first, walls)  # for phase 18
    print(f"phase 13 config 5 (16 x 2^24 samples): ok steps "
          f"{[st[0] for st in sw.n_steps]}, max BER {float(sw.ber.max())}, "
          f"thresholds {float(sw.threshold.min()):.5f}-"
          f"{float(sw.threshold.max()):.5f} (JAX mean "
          f"{PINNED5['threshold']}), mu1 {float(sw.mu1.min()):.5f}-"
          f"{float(sw.mu1.max()):.5f}; launches of one sweep {launches5}; "
          f"wall first {t_first:.3f} s, then "
          f"{', '.join(f'{w:.3f}' for w in walls)} s; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    sw, launches5d, t_first, _, peak = sweep5(DEFINED_BITS5, steady=0)
    print(f"phase 13 config 5 as defined (16 x 2^26 samples): ok steps "
          f"{[st[0] for st in sw.n_steps]}, max BER {float(sw.ber.max())}, "
          f"thresholds {float(sw.threshold.min()):.5f}-"
          f"{float(sw.threshold.max()):.5f}; launches {launches5d}; one "
          f"sweep {t_first:.3f} s (with the build and the bits "
          f"{time.perf_counter() - t0:.1f} s); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    del sw

    # the batched hard PPM receiver: config 3's physics, 4 channels
    prog = link.build_link(spec3, WDM_PPM_SYM * M3, params3, device=dev)
    bits = prbs(15, length=WDM_PPM_CH * WDM_PPM_SYM * 3)[0].reshape(
        WDM_PPM_CH, -1)
    swp, launches_wp, t_first, walls, peak = timed_call(
        torch, kernels, lambda: prog.dsp_wdm_ppm(
            WDM_PPM_CH, M=M3, decision="hard", bits=bits, seed=5), steady=1)
    check(launches_wp["histogram2d"] == 1, 13,
          f"dsp_wdm_ppm launched {launches_wp['histogram2d']} histograms")
    for c in range(WDM_PPM_CH):
        d = prog.dsp_ppm(M3, decision="hard", bits=bits[c], seed=5 + c)
        check(swp.n_errors[c] == d.n_errors and swp.n_steps[c] == d.n_steps
              and abs(swp.threshold[c] - d.threshold)
              <= 1e-6 * abs(d.threshold), 13,
              f"dsp_wdm_ppm channel {c}: {swp.n_errors[c]} errors, threshold "
              f"{swp.threshold[c]}; dsp_ppm {d.n_errors}, {d.threshold}")
    check(float(swp.ber.max()) <= 1e-4, 13, f"dsp_wdm_ppm BER {swp.ber}")
    print(f"phase 13 dsp_wdm_ppm(4, M=8, hard) (2^22 samples a channel): ok "
          f"equal to dsp_ppm a channel, n_errors {swp.n_errors.tolist()}, "
          f"thresholds {[round(float(t), 6) for t in swp.threshold]}; "
          f"launches {launches_wp}; wall first {t_first:.3f} s, then "
          f"{walls[0]:.3f} s", flush=True)
    del prog, swp

    # ---- phase 14: LinkProgram.eye on config 2 at full size ----
    prog = link.build_link(spec, N_BITS, params, device=dev)
    bits = prbs(15, length=N_BITS)[0]
    d = prog.dsp(bits=bits, seed=3)
    e, launches_eye, t_first, walls, peak = timed_call(
        torch, kernels, lambda: prog.eye(bits=bits, seed=3, sps_resamp=128),
        steady=1)
    check(launches_eye["histogram2d"] == 1
          and launches_eye["nl_halfstep"] >= PINNED["n_steps"], 14,
          f"launches {launches_eye}")
    for k in ("mu0", "mu1", "s0", "s1", "threshold", "t_opt", "er", "eye_h"):
        check(abs(getattr(e, k) - getattr(d.eye, k))
              <= 1e-6 * abs(getattr(d.eye, k)), 14,
              f"eye {k} {getattr(e, k)} vs dsp {getattr(d.eye, k)}")
    check(e.i == d.eye.i and e.y is None, 14, "eye without traces")
    kernels.reset_launches()
    et = prog.eye(bits=bits, seed=3, sps_resamp=128, with_traces=True)
    check(all(isinstance(getattr(et, k), torch.Tensor)
              and getattr(et, k).device.type == "cuda"
              for k in ("y", "t", "y_top", "y_bot", "y_25_75")), 14,
          "the traces are not tensors on the card")
    occ, te, ye, hy = et.density(256)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["histogram2d"] == 3, 14,
          f"eye + density launched {kernels.LAUNCHES['histogram2d']} "
          "histograms, expected 3 (KDE, occupancy, amplitudes)")
    sps_e = int(et.sps_resamp)
    y_np = np.roll(et.y.cpu().numpy().astype(np.float64),
                   -sps_e // 2)[sps_e // 2:-sps_e // 2]
    t_np = et.t.cpu().numpy().astype(np.float64)[:-sps_e]
    occ_np, te_np, ye_np = np.histogram2d(t_np, y_np, bins=256)
    check(np.array_equal(occ.cpu().numpy(), occ_np)
          and np.array_equal(te, te_np) and np.array_equal(ye, ye_np), 14,
          "the (256, 256) density differs from np.histogram2d at "
          f"{int((occ.cpu().numpy() != occ_np).sum())} bins")
    check(float(hy.sum()) > 0 and float(occ.sum()) == y_np.size, 14,
          "density counts")
    print(f"phase 14 eye (config 2, 2^24 samples): ok scalars equal dsp's "
          f"(mu1 {e.mu1:.5f}, threshold {e.threshold:.5f}); launches "
          f"{launches_eye}; wall first {t_first:.3f} s, then {walls[0]:.3f} "
          f"s; {y_np.size} trace samples on the card, (256, 256) density "
          f"equal to np.histogram2d (max bin {int(occ.max())})", flush=True)
    del prog, d, e, et

    # ---- phase 15: the resumable fiber on the card ----
    import tempfile

    from opticomlib_tpu_torch import runtime
    from opticomlib_tpu_torch.ops import noise as noise_ops, ssfm
    from opticomlib_tpu_torch.runtime.checkpoint import \
        PropagationCheckpointer

    # config 2's launch field: the program's field before any fiber
    b2b = link.build_link(dataclasses.replace(spec, stages=()), N_BITS,
                          params, device=dev, return_field=True)
    A0 = b2b.run(bits=prbs(15, length=N_BITS)[0]).field.contiguous()
    del b2b
    n = A0.numel()
    check(n == 2**24 and A0.dtype == torch.complex64, 15,
          f"launch field {tuple(A0.shape)} {A0.dtype}")
    w = 2 * np.pi * np.fft.fftfreq(n) * params.fs
    fib = dict(alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.01)
    SEG = 10.0

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def dying_save(after):
        """Patch the checkpointer to raise once ``after`` saves are on disk;
        returns the undo."""
        orig, calls = PropagationCheckpointer.save, {"n": 0}

        def save(self, *a, **kw):
            out = orig(self, *a, **kw)
            calls["n"] += 1
            if calls["n"] == after:
                raise RuntimeError("killed after a save")
            return out

        PropagationCheckpointer.save = save
        return lambda: setattr(PropagationCheckpointer, "save", orig)

    saves = []  # (seconds, bytes) of every save of this phase
    plain_save = PropagationCheckpointer.save

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        path = plain_save(self, *a, **kw)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        return path

    ssfm.ssfm_propagate(A0, w, 50.0, **fib)  # warm-up (cuFFT plans)
    (straight, steps_straight), t_straight = wall(
        lambda: ssfm.ssfm_propagate(A0, w, 50.0, **fib))
    check(steps_straight == PINNED["n_steps"], 15,
          f"unsegmented n_steps {steps_straight}")

    def segments_by_hand():
        A, steps = A0, 0
        for _ in range(5):
            A, st = ssfm.ssfm_propagate(A, w, SEG, **fib)
            steps += st
        return A, steps

    (by_hand, steps_seg), t_by_hand = wall(segments_by_hand)
    with tempfile.TemporaryDirectory() as tmp:
        PropagationCheckpointer.save = timed_save
        try:
            kernels.reset_launches()
            whole, t_whole = wall(lambda: runtime.ssfm_propagate_resumable(
                A0, w, 50.0, os.path.join(tmp, "whole"), SEG, **fib))
            launches_res = dict(kernels.LAUNCHES)
        finally:
            PropagationCheckpointer.save = plain_save
        check(len(saves) == 5 and sorted(os.listdir(os.path.join(
            tmp, "whole"))) == ["ckpt_00000004.npz", "ckpt_00000005.npz"], 15,
            f"{len(saves)} saves, files "
            f"{os.listdir(os.path.join(tmp, 'whole'))}")
        undo = dying_save(2)
        try:
            runtime.ssfm_propagate_resumable(
                A0, w, 50.0, os.path.join(tmp, "crash"), SEG, **fib)
            fail(15, "the run was not killed")
        except RuntimeError as exc:
            check("killed after a save" in str(exc), 15, str(exc))
        finally:
            undo()
        resumed, t_resumed = wall(lambda: runtime.ssfm_propagate_resumable(
            A0, w, 50.0, os.path.join(tmp, "crash"), SEG, **fib))
    check(whole.device == A0.device and whole.dtype == torch.complex64, 15,
          f"result on {whole.device} as {whole.dtype}")
    check(torch.equal(resumed, whole), 15, "the resumed run differs from the "
          f"whole run: max abs {float((resumed - whole).abs().max()):.3g}")
    check(torch.equal(by_hand, whole), 15,
          "the resumable run differs from its segments run by hand")
    peak_amp = float(straight.abs().max())
    err_seg = float((whole - straight).abs().max()) / peak_amp
    check(err_seg <= 2e-4, 15, f"segmented vs unsegmented: max abs err / "
          f"peak {err_seg:.3g} > 2e-4")
    # Adaptive segments probe h0 anew at every boundary and clip their last
    # step to it (61 steps against 58), so they differ from the straight run
    # by the splitting error.  tests/test_runtime.py's atol=1e-5 on a field of
    # amplitude 0.2 (5e-5 of the peak) is for its fixed steps, where the
    # segments take the straight run's steps: held here at h = 1 km.
    fixed = dict(fib, h=1.0)
    A_seg = A0
    for _ in range(5):
        A_seg = ssfm.ssfm_propagate(A_seg, w, SEG, **fixed)[0]
    straight_fixed = ssfm.ssfm_propagate(A0, w, 50.0, **fixed)[0]
    err_fixed = float((A_seg - straight_fixed).abs().max()) / peak_amp
    check(err_fixed <= 5e-5, 15, f"fixed-step segments vs the straight run: "
          f"max abs err / peak {err_fixed:.3g} > 5e-5")
    del A_seg, straight_fixed
    check(launches_res["nl_halfstep"] == steps_seg
          and launches_res["cmul"] == 2 * steps_seg, 15,
          f"launches {launches_res} for {steps_seg} steps")
    s_save = statistics.median(t for t, _ in saves)
    print(f"phase 15 resumable fiber (2^24 samples, 50 km in 5 segments): ok "
          f"resumed after 2 saves bit-equal to the whole run, segmented vs "
          f"unsegmented {err_seg:.3g} of the peak ({steps_seg} vs "
          f"{steps_straight} steps; at fixed h = 1 km {err_fixed:.3g}); "
          f"launches {launches_res}", flush=True)
    print(f"phase 15 wall s: unsegmented {t_straight:.3f}, 5 segments "
          f"without checkpoints {t_by_hand:.3f}, with {t_whole:.3f}, resume "
          f"of the last 3 {t_resumed:.3f}", flush=True)
    print(f"phase 15 save: {saves[0][1]} bytes a file, median "
          f"{s_save:.3f} s to write one ({saves[0][1] / s_save / 1e9:.2f} "
          f"GB/s), checkpoints cost {(t_whole - t_by_hand) / 5:.3f} s a "
          f"segment with the copy to the host", flush=True)
    del by_hand, resumed

    # span_chain_resumable over 4 of config 4's spans: 80 km o4 at h = 20 km,
    # 16 dB of gain, 2-polarisation ASE from a generator keyed by the span
    span4 = spec4.stages[0].stages[0]
    phi_w4 = torch.as_tensor(ssfm.dispersion_phase(w, span4.beta_2, 0.0),
                             device=dev)
    hs4 = ssfm.ssfm_step_schedule(span4.length, span4.h)
    sigma4 = noise_ops.ase_sigma(16, 5, params.f0, params.fs)
    gain4 = float(np.float32(10 ** (16 / 20)))

    def apply_span(A, s):
        A = ssfm.ssfm_o4_scan_inside(A, phi_w4, hs4, span4.gamma,
                                     ssfm.alpha_per_km(span4.alpha)) * gain4
        gen = torch.Generator(device=dev).manual_seed(3 * 2**16 + s)
        d = noise_ops.gaussian((4, n), sigma4, gen)
        return A + torch.complex(d[:2], d[2:])

    # config 4 launches 10 dBm: 6 dB below config 2's field
    A4 = torch.stack([A0, A0]) * float(np.float32(10 ** (-6 / 20) / 2**0.5))
    saves.clear()
    with tempfile.TemporaryDirectory() as tmp:
        PropagationCheckpointer.save = timed_save
        try:
            kernels.reset_launches()
            full4, t_full4 = wall(lambda: runtime.span_chain_resumable(
                A4, apply_span, 4, os.path.join(tmp, "full"),
                dict(physics="config 4 spans")))
            launches_chain = dict(kernels.LAUNCHES)
        finally:
            PropagationCheckpointer.save = plain_save
        undo = dying_save(2)
        try:
            runtime.span_chain_resumable(A4, apply_span, 4, os.path.join(
                tmp, "crash"), dict(physics="config 4 spans"))
            fail(15, "the span chain was not killed")
        except RuntimeError as exc:
            check("killed after a save" in str(exc), 15, str(exc))
        finally:
            undo()
        resumed4 = runtime.span_chain_resumable(
            A4, apply_span, 4, os.path.join(tmp, "crash"),
            dict(physics="config 4 spans"))
    (_, t_nockpt4) = wall(lambda: functools.reduce(
        apply_span, range(4), A4))
    check(torch.equal(resumed4, full4), 15,
          "the resumed span chain differs from the uninterrupted one")
    check(bool(torch.isfinite(torch.view_as_real(full4)).all())
          and full4.shape == (2, n), 15, "span chain output")
    check(launches_chain["nl_halfstep"] == 4 * 4 * 6
          and launches_chain["cmul"] == 4 * 4 * 3, 15,
          f"launches {launches_chain}")
    print(f"phase 15 span_chain_resumable (4 x 80 km o4 spans, (2, 2^24)): "
          f"ok killed after 2 saves and resumed bit-equal; launches "
          f"{launches_chain}; wall {t_full4:.3f} s with checkpoints, "
          f"{t_nockpt4:.3f} s without; {saves[0][1]} bytes a file, median "
          f"{statistics.median(t for t, _ in saves):.3f} s a save",
          flush=True)
    del full4, resumed4, A4, phi_w4

    # ---- phase 16: the sharded fiber at world size 1 over NCCL ----
    import torch.distributed as dist

    from opticomlib_tpu_torch import devices as D, gv
    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_link_mesh, ssfm_sharded)
    from opticomlib_tpu_torch.parallel.fiber import ShardedField
    from opticomlib_tpu_torch.signals import OpticalSignal

    gv.default()  # no device named: the card
    rendezvous = tempfile.TemporaryDirectory()  # kept until the group ends
    world = initialize_multihost(f"file://{rendezvous.name}/rendezvous", 1,
                                 0, timeout_s=120)
    check(world == 1 and dist.get_backend() == "nccl", 16,
          f"world {world}, backend {dist.get_backend()}")
    mesh = make_link_mesh(1, 1)
    check(mesh.device.type == "cuda" and mesh.shape == {"wdm": 1, "time": 1},
          16, f"{mesh!r}")
    base = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
    o4 = dict(alpha=span4.alpha, beta_2=span4.beta_2, gamma=span4.gamma)
    # the unsharded call builds its phase grid on the host every time (most
    # of its wall time); its steps alone, on a phase grid kept on the card as
    # the sharded solver keeps its own, are timed beside it
    phi_dev = torch.as_tensor(ssfm.dispersion_phase(w, -21.0, 0.0), device=dev)
    a_km = ssfm.alpha_per_km(0.2)

    def steps_adaptive():
        with np.errstate(divide="ignore"):
            h0 = min(np.float32(0.01) / (np.float32(1.3) * ssfm.max_power(A0)),
                     np.float32(50.0))
        return ssfm.ssfm_while_inside(A0, phi_dev, 50.0, 1.3, 0.01, h0, a_km,
                                      adaptive=True)

    def steps_fixed():
        return ssfm.ssfm_scan_inside(A0, phi_dev, ssfm.ssfm_step_schedule(
            50.0, 1.0), 1.3, a_km)

    sharded_cases = {
        # name: (ssfm_sharded keywords, the unsharded call, its steps alone,
        # tolerance / peak)
        "pencil_adaptive": (
            dict(length=50.0, h=None, phi_max=0.01, **base),
            lambda: ssfm.ssfm_propagate(A0, w, 50.0, phi_max=0.01, **base),
            steps_adaptive, 5e-4),
        "pencil_fixed": (
            dict(length=50.0, h=1.0, **base),
            lambda: ssfm.ssfm_propagate(A0, w, 50.0, h=1.0, **base),
            steps_fixed, 5e-4),
        "overlap_fixed": (
            dict(length=50.0, h=1.0, method="overlap", **base),
            lambda: ssfm.ssfm_propagate(A0, w, 50.0, h=1.0, **base),
            steps_fixed, 5e-3),
        "o4_fixed": (
            dict(length=80.0, h=20.0, scheme="o4", **o4),
            lambda: ssfm.ssfm_scan_o4(A0, w, 80.0, h=20.0, **o4),
            lambda: ssfm.ssfm_o4_scan_inside(
                A0, phi_dev, ssfm.ssfm_step_schedule(80.0, 20.0), 1.3, a_km),
            5e-4),
    }
    # a tensor that lies elsewhere than the mesh computes is refused, not
    # moved
    try:
        ssfm_sharded(A0.cpu(), mesh, fs=params.fs, length=1.0, h=1.0, **base)
        fail(16, "a CPU tensor on a mesh of cards did not raise")
    except ValueError as e:
        check("initialize_multihost(device=" in str(e), 16, str(e))
    launches_sharded, lines16 = {}, []
    for name, (kw, unsharded, steps_alone, tol_peak) in sharded_cases.items():
        ssfm_sharded(A0, mesh, fs=params.fs, **kw)  # plans, twiddles, warm-up
        unsharded()
        kernels.reset_launches()
        out, t_sh = wall(lambda: ssfm_sharded(A0, mesh, fs=params.fs, **kw))
        launches_sharded[name] = dict(kernels.LAUNCHES)
        (ref, steps_ref), t_un = wall(unsharded)
        _, t_alone = wall(steps_alone)
        check(isinstance(out, ShardedField) and out.local.device == A0.device
              and out.shape == (n,), 16, f"{name}: {out!r}")
        check(out.n_steps == steps_ref, 16,
              f"{name}: {out.n_steps} steps, unsharded {steps_ref}")
        e16 = float((out.local - ref).abs().max() / ref.abs().max())
        check(e16 <= tol_peak, 16, f"{name}: max abs err / peak {e16:.3g} > "
              f"{tol_peak}")
        check(launches_sharded[name]["nl_halfstep"] > 0
              and launches_sharded[name]["cmul"] > 0, 16,
              f"{name}: launches {launches_sharded[name]}")
        lines16.append(f"{name} {out.n_steps} steps, err/peak {e16:.2g}, "
                       f"{t_sh:.3f} s vs unsharded {t_un:.3f} s (its steps "
                       f"alone {t_alone:.3f} s), launches "
                       f"nl_halfstep {launches_sharded[name]['nl_halfstep']} "
                       f"cmul {launches_sharded[name]['cmul']}")
        if name == "pencil_adaptive":
            host = np.asarray(out)  # the gather, a collective
            check(host.shape == (n,) and np.array_equal(
                host, out.local.cpu().numpy()), 16, "gather at world size 1")
            del host
        del out, ref
    print("phase 16 sharded fiber, world size 1 over NCCL (2^24 samples): ok "
          + "; ".join(lines16), flush=True)
    # the staged drop-in, gv with no device named
    gv(sps=SPS, R=R, N=N_BITS)
    x = OpticalSignal(A0)
    kw = dict(length=50, phi_max=0.01, **base)
    D.FIBER(x, mesh=mesh, **kw)
    kernels.reset_launches()
    o1, t_mesh = wall(lambda: D.FIBER(x, mesh=mesh, **kw))
    launches_sharded["fiber_mesh"] = dict(kernels.LAUNCHES)
    o_plain, t_plain = wall(lambda: D.FIBER(x, **kw))
    check(isinstance(o1.signal, ShardedField) and o1.device.type == "cuda",
          16, f"FIBER(mesh=) payload {type(o1.signal).__name__}")
    check(o1.n_steps == o_plain.n_steps == PINNED["n_steps"], 16,
          f"FIBER(mesh=) {o1.n_steps} steps, FIBER {o_plain.n_steps}")
    e16 = float((o1.signal.local - o_plain.signal).abs().max()
                / o_plain.signal.abs().max())
    check(e16 <= 5e-4, 16, f"FIBER(mesh=): max abs err / peak {e16:.3g}")
    o2 = D.FIBER(o1, mesh=mesh, **kw)  # the payload stays where it lies
    check(isinstance(o2.signal, ShardedField) and o2.to_numpy().shape == (n,),
          16, "chained FIBER(mesh=)")
    try:
        D.FIBER(x, mesh=mesh, return_steps=True, **kw)
        fail(16, "FIBER(mesh=, return_steps=True) did not raise")
    except ValueError:
        pass
    gv.default()
    print(f"phase 16 FIBER(mesh=) through gv, no device named: ok "
          f"{o1.n_steps} steps, err/peak {e16:.2g}, {t_mesh:.3f} s vs FIBER "
          f"{t_plain:.3f} s; launches {launches_sharded['fiber_mesh']}",
          flush=True)
    del o1, o2, o_plain, x, straight, whole, phi_dev

    # ---- phase 17: profiling ----
    import glob

    from opticomlib_tpu_torch.utils import profiling

    prog = link.build_link(spec, N_BITS, params, device=dev)
    bits = prbs(15, length=N_BITS)[0]
    prog.dsp(bits=bits, seed=3)
    plain_fiber = prog._fiber

    def annotated_fiber(*a, **kw):
        with profiling.annotate("ssfm"):
            return plain_fiber(*a, **kw)

    prog._fiber = annotated_fiber
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            d = prog.dsp(bits=bits, seed=3)
        files = glob.glob(os.path.join(tmp, "trace_*.json"))
        check(len(files) == 1, 17, f"trace files {files}")
        trace_bytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    prog._fiber = plain_fiber
    check("ssfm" in names, 17, "the region's name is not in the trace")
    check(any("_nl_halfstep_kernel" in str(nm) for nm in names), 17,
          "nl_halfstep's kernel is not in the trace")
    check(any("cmul" in str(nm) for nm in names), 17,
          "cmul's kernel is not in the trace")
    check(d.n_steps == (PINNED["n_steps"],), 17, f"n_steps {d.n_steps}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profiling.DeviceTimer(dev) as timer:
        start.record()
        d = prog.dsp(bits=bits, seed=3)
        end.record()
        timer.sync(prog.H2_pd)
    ev_ms = start.elapsed_time(end)
    check(abs(timer.elapsed * 1e3 - ev_ms) <= 0.05 * ev_ms, 17,
          f"DeviceTimer {timer.elapsed * 1e3:.3f} ms vs CUDA events "
          f"{ev_ms:.3f} ms")
    print(f"phase 17 profiling (config 2 dsp, 2^24 samples): ok trace "
          f"{trace_bytes} bytes, {len(names)} event names with the 'ssfm' "
          f"region, _nl_halfstep_kernel and cmul in it; DeviceTimer "
          f"{timer.elapsed * 1e3:.3f} ms vs CUDA events {ev_ms:.3f} ms",
          flush=True)
    del prog, d

    # ---- phase 18: the sharded fused link at world size 1 over NCCL ----
    from opticomlib_tpu_torch.parallel.fiber import make_mesh

    def held(a, b, tol, what):
        """``a`` (this rank's block of a sharded output, or a tensor) within
        ``tol`` of the peak of ``b``; returns the error."""
        a = a.local if isinstance(a, ShardedField) else a
        err = float((a.reshape(b.shape) - b).abs().max() / b.abs().max())
        check(err <= tol, 18, f"{what}: max abs err / peak {err:.3g} > {tol}")
        return err

    # 1. card against card, 2^20 samples: noiseless, then on the same draws
    rng = np.random.default_rng(18)
    quiet2 = dataclasses.replace(spec, include_thermal=False,
                                 include_shot=False, stages=(
                                     spec.stages[0], link.EDFASpec(G=10)))
    quiet4 = dataclasses.replace(config4_spec(link, noisy=False),
                                 include_thermal=False, include_shot=False)
    n = SMALL_BITS * SPS                      # = SMALL_BITS4 * SPS4
    draws = {"ase": [rng.standard_normal((4, n), dtype=np.float32)
                     for _ in range(20)]}
    for k in ("phase", "rin", "thermal", "shot"):
        draws[k] = rng.standard_normal(n, dtype=np.float32)
    # tolerance / peak: config 2 the JAX tests' 2e-5; config 4's 40
    # nonlinear spans grow the round-off between the two programs' orders
    # of the same chain (the float32 strided dispersion phase, the DAC's
    # complex-input transform) to 2.3e-5-2.8e-5 of the peak at 2^20 samples
    # (scripts/compare_sharded_link.py on the CPU), so 5e-5
    lines18 = []
    for name, sp, pr_, nb, noise, tol in (
            ("config 2 noiseless", quiet2, params, SMALL_BITS, None, 2e-5),
            ("config 4 noiseless", quiet4, params4, SMALL_BITS4, None, 5e-5),
            ("config 2 on the same draws", spec, params, SMALL_BITS,
             dict(draws, ase=draws["ase"][:1]), 2e-5),
            ("config 4 before its ADC on the same draws",
             dataclasses.replace(spec4, adc_bits=None), params4, SMALL_BITS4,
             draws, 5e-5)):
        b = prbs(15, length=nb)[0].astype(np.float32)
        o1 = link.build_link(sp, nb, pr_, mesh=mesh).jitted(
            b, [3], noise=None if noise is None else [noise])
        o0 = link.build_link(sp, nb, pr_, device=dev).jitted(
            torch.as_tensor(b, device=dev), 3, noise=noise)
        check([int(st[0]) for st in o1[2]] == list(o0[2]), 18,
              f"{name}: steps {[st.tolist() for st in o1[2]]} vs {o0[2]}")
        e18 = held(o1[0], o0[0], tol, name)
        lines18.append(f"{name} {e18:.2g} ({sum(o0[2])} steps)")
    print("phase 18 sharded link vs LinkProgram on the card (2^20 samples): "
          "ok v err/peak " + "; ".join(lines18), flush=True)
    del o0, o1, draws

    def sharded_call(tag, fn, steady=1):
        out = timed_call(torch, kernels, fn, steady=steady)
        launches_sharded[tag] = out[1]
        return out

    def walls_line(out, unsharded):
        steady = ", ".join(f"{w:.3f}" for w in unsharded[1])
        return (f"wall first {out[2]:.3f} s, then "
                f"{', '.join(f'{w:.3f}' for w in out[3])} s (unsharded "
                f"{unsharded[0]:.3f}" + (f", then {steady}" if steady else "")
                + f" s); peak memory {out[4] / 2**30:.2f} GiB; launches "
                f"{out[1]}")

    # 2. config 2 at 2^24 samples, ShardedLinkProgram.dsp
    prog = link.build_link(spec, N_BITS, params, mesh=mesh)
    bits = prbs(15, length=N_BITS)[0]
    out = sharded_call("link_config2", lambda: prog.dsp(bits=bits, seed=3))
    d = out[0]
    check(d.n_steps == (PINNED["n_steps"],) and out[1]["nl_halfstep"] >= 58
          and out[1]["cmul"] >= 116 and out[1]["histogram2d"] >= 1, 18,
          f"config 2: steps {d.n_steps}, launches {out[1]}")
    hold_to_pin(d, PINNED, 18)
    print(f"phase 18 config 2 sharded dsp (2^24 samples): ok {d.n_steps[0]} "
          f"steps, BER {d.ber}, threshold {d.threshold:.5f} (JAX "
          f"{PINNED['threshold']}); "
          + walls_line(out, unsharded_walls["config2"]), flush=True)
    del prog, d, out

    # 3. config 4 at 2^24 samples: o4, DBP, the ADC through the sharded range
    prog = link.build_link(spec4, N_BITS4, params4, mesh=mesh)
    bits = prbs(15, length=N_BITS4)[0]
    out = sharded_call("link_config4", lambda: prog.dsp(bits=bits, seed=3))
    d = out[0]
    check(d.n_steps == (4,) * 40 and d.rin_ok
          and out[1]["adc_quantize"] >= 1 and out[1]["histogram2d"] >= 2, 18,
          f"config 4: steps {d.n_steps}, rin_ok {d.rin_ok}, launches "
          f"{out[1]}")
    hold_to_pin(d, PINNED4, 18)
    print(f"phase 18 config 4 sharded dsp (2^24 samples): ok "
          f"{sum(d.n_steps)} o4 steps, BER {d.ber}, threshold "
          f"{d.threshold:.6f} (JAX {PINNED4['threshold']}); "
          + walls_line(out, unsharded_walls["config4"]), flush=True)
    del prog, d, out

    # 4. config 5: dsp_wdm(16) of the sharded program, 16 x 2^24 on the card
    prog = link.build_link(spec, N_BITS5, params5, mesh=mesh)
    bits = bits5(N_BITS5)
    out = sharded_call("link_config5", lambda: prog.dsp_wdm(
        N_CH5, bits=bits, seed=5))
    sw = out[0]
    check(sw.n_steps == sw5.n_steps, 18,
          f"config 5 steps {sw.n_steps} vs the unsharded sweep's "
          f"{sw5.n_steps}")
    check(float(sw.ber.max()) <= 1e-4 and sw.rin_ok.all(), 18,
          f"config 5 BER {sw.ber}")
    for k, spread in PINNED5_STD.items():
        off = np.abs(getattr(sw, k) - PINNED5[k]) / spread
        check(off.max() <= 5, 18, f"config 5 channel {int(off.argmax())}: "
              f"{k} is {off.max():.1f} deviations from the JAX mean")
    print(f"phase 18 config 5 sharded dsp_wdm(16) (16 x 2^24 samples): ok "
          f"steps {[st[0] for st in sw.n_steps]} (the unsharded sweep's), "
          f"max BER {float(sw.ber.max())}, thresholds "
          f"{float(sw.threshold.min()):.5f}-{float(sw.threshold.max()):.5f}; "
          + walls_line(out, unsharded_walls["config5"]), flush=True)
    del prog, sw, out

    # 5. LinkProgram.dsp_wdm over a 1-D 'wdm' mesh equals the plain sweep,
    # which runs again first for its wall time in the same state
    prog = link.build_link(spec, N_BITS5, params5, device=dev)
    plain = timed_call(torch, kernels, lambda: prog.dsp_wdm(
        N_CH5, bits=bits, seed=5), steady=1)
    out = sharded_call("mesh_sweep_config5", lambda: prog.dsp_wdm(
        N_CH5, bits=bits, seed=5, mesh=make_mesh([0], ("wdm",))))
    sw = out[0]
    check(np.array_equal(sw.n_errors, sw5.n_errors)
          and sw.n_steps == sw5.n_steps
          and np.array_equal(sw.threshold, sw5.threshold), 18,
          f"dsp_wdm(mesh=): errors {sw.n_errors}, thresholds "
          f"{sw.threshold} vs {sw5.n_errors}, {sw5.threshold}")
    print(f"phase 18 LinkProgram.dsp_wdm(16, mesh='wdm' of one card): ok "
          f"errors, steps and thresholds equal to the plain sweep's; "
          + walls_line(out, plain[2:4]), flush=True)
    del prog, sw, out, bits, sw5, plain

    # 6. a staged device after FIBER(mesh=): PD on the whole field
    gv(sps=SPS, R=R, N=N_BITS)
    x = OpticalSignal(A0)
    kw = dict(length=50, phi_max=0.01, **base)
    pd_kw = dict(BW=0.75 * R, include_noise="none")
    out = sharded_call("staged_pd_after_fiber_mesh", lambda: D.PD(
        D.FIBER(x, mesh=mesh, **kw), **pd_kw))
    (ref, t_ref) = wall(lambda: D.PD(D.FIBER(x, **kw), **pd_kw))
    check(out[0].device.type == "cuda", 18, "PD(FIBER(mesh=)) left the card")
    e18 = held(out[0].signal, ref.signal, 5e-4, "PD(FIBER(mesh=))")
    gv.default()
    print(f"phase 18 PD(FIBER(x, mesh=mesh)) (2^24 samples): ok err/peak "
          f"{e18:.2g}; "
          + walls_line(out, (t_ref, [])), flush=True)
    del x, out, ref

    # ---- phase 19: the span-pipelined link at world size 1 over NCCL ----
    # Cut to size: one card is one rank, so S = 1 (the JAX package's runs
    # take 8 devices): the 40 segments of config 4 run on the one rank and
    # every point-to-point move of the schedule is a local copy; 4 channels
    # at full width, not 16, to keep the script within its time.
    from opticomlib_tpu_torch.parallel import make_span_mesh, span_pipeline

    t19 = time.perf_counter()
    smesh = make_span_mesh(1)
    check(smesh.device.type == "cuda" and smesh.shape == {"span": 1}, 19,
          f"{smesh!r}")
    # 1. the card's pipelined chain against the CPU's sequential LinkProgram
    # on the same numpy draws, 2 channels at 2^18 samples: the voltage
    # before the ADC (eye windows and slot samples)
    nb = 2**14
    n = nb * SPS4
    rng = np.random.default_rng(19)
    draws = [{"phase": rng.standard_normal(n, dtype=np.float32),
              "rin": rng.standard_normal(n, dtype=np.float32),
              "ase": [rng.standard_normal((4, n), dtype=np.float32)
                      for _ in range(20)],
              "thermal": rng.standard_normal(n, dtype=np.float32),
              "shot": rng.standard_normal(n, dtype=np.float32)}
             for _ in range(2)]
    bits = prbs(15, length=2 * nb)[0].reshape(2, nb)
    spec19 = dataclasses.replace(spec4, adc_bits=None)
    t0 = time.perf_counter()
    pr = link.build_link(spec19, nb, params4, span_mesh=smesh)
    wins, slots, ok = pr._chain(bits, 7, draws, 8192, pr._channels(2))
    v_g = torch.cat([wins, slots], 1).cpu().numpy()
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = link.build_link(spec19, nb, params4, device="cpu")
    v_c, ok_c = [], []
    for c in range(2):
        v, vs, _, ok1 = seq(torch.as_tensor(bits[c]), seed=7 + c,
                            noise=draws[c])
        v_c.append(torch.cat([v[:wins.shape[1]], vs]).numpy())
        ok_c.append(bool(ok1))
    v_c = np.stack(v_c)
    t_c = time.perf_counter() - t0
    rel = float(np.linalg.norm(v_g - v_c) / np.linalg.norm(v_c))
    check(rel <= 1e-3 and bool(ok.all()) and all(ok_c), 19,
          f"card vs CPU: v rel L2 {rel:.3g} > 1e-3 (rin_ok {ok.tolist()}, "
          f"{ok_c})")
    print(f"phase 19 pipelined config 4 on the card vs LinkProgram on the CPU "
          f"(2 x 2^18 samples, S = 1): ok v rel L2 {rel:.3g} before the ADC; "
          f"card {t_g:.1f} s, CPU {t_c:.1f} s", flush=True)
    del draws, pr, seq, wins, slots, v_g, v_c, v, vs

    # 2. against the port's sequential link: config 4 noiseless, 2 x 2^20
    nb = SMALL_BITS4
    pr = link.build_link(quiet4, nb, params4, span_mesh=smesh)
    sw_p = pr.dsp_wdm(2, seed=0)
    sw_s = link.build_link(quiet4, nb, params4, device=dev).dsp_wdm(
        2, bits=sw_p.tx, seed=0)
    d_th = float(np.max(np.abs(sw_p.threshold / sw_s.threshold - 1)))
    d_mu = float(np.max(np.abs(sw_p.mu1 / sw_s.mu1 - 1)))
    check(np.array_equal(sw_p.ber, sw_s.ber) and d_th <= 1e-4
          and d_mu <= 1e-4, 19,
          f"pipelined vs sequential: BER {sw_p.ber} vs {sw_s.ber}, "
          f"thresholds rel {d_th:.3g}, mu1 rel {d_mu:.3g}")
    print(f"phase 19 pipelined vs LinkProgram.dsp_wdm, config 4 noiseless "
          f"(2 x 2^20 samples): ok BER {sw_p.ber.tolist()} equal, "
          f"thresholds rel {d_th:.2g}, mu1 rel {d_mu:.2g}", flush=True)
    del pr, sw_p, sw_s

    # 3. full width: config 4 at 2^24 samples a channel, 4 channels
    pr = link.build_link(spec4, N_BITS4, params4, span_mesh=smesh)
    out = timed_call(torch, kernels, lambda: pr.dsp_wdm(
        4, seed=3, sps_resamp=128), steady=2)
    sw, launches19 = out[0], out[1]
    check(launches19["nl_halfstep"] >= 4 * 960 and launches19["cmul"] >= 4 * 480
          and launches19["histogram2d"] >= 1
          and launches19["adc_quantize"] >= 4, 19, f"launches {launches19}")
    check(sw.rin_ok.all(), 19, "a RIN draw was clamped")
    print(f"phase 19 dsp_wdm(4) channels: thresholds "
          f"{sw.threshold.tolist()}, mu1 {sw.mu1.tolist()}", flush=True)
    # each channel runs on its own noise draws, not the pin's: its
    # threshold is held within 5 standard deviations of the difference of
    # two thresholds (1.2e-3 here; 2 % of the pin is 2.1 of them), as
    # hold_to_pin holds the levels within 5 standard errors
    slack = max(0.0, 5 * threshold_spread(PINNED4)
                - 0.02 * PINNED4["threshold"])
    for c in range(4):
        hold_to_pin(SimpleNamespace(
            ber=float(sw.ber[c]), threshold=float(sw.threshold[c]),
            eye=SimpleNamespace(**{k: float(getattr(sw, k)[c])
                                   for k in ("mu0", "mu1", "s0", "s1")})),
            PINNED4, 19, threshold_slack=slack)
    again = pr.dsp_wdm(4, seed=3, sps_resamp=128)
    other = pr.dsp_wdm(4, bits=sw.tx, seed=4, sps_resamp=128)
    check(all(np.array_equal(getattr(again, k), getattr(sw, k)) for k in
              ("threshold", "n_errors", "mu0", "mu1", "s0", "s1")), 19,
          "the same seed gave other scalars")
    check(not np.array_equal(other.threshold, sw.threshold), 19,
          "another seed left the thresholds where they were")
    print(f"phase 19 pipelined config 4 dsp_wdm(4) (4 x 2^24 samples, 40 "
          f"segments on one rank): ok BER {sw.ber.tolist()}, thresholds "
          f"{sw.threshold.tolist()} (JAX {PINNED4['threshold']}); wall first "
          f"{out[2]:.3f} s, then {', '.join(f'{x:.3f}' for x in out[3])} s "
          f"(unsharded dsp a channel {unsharded_walls['config4'][0]:.3f}, "
          f"then {', '.join(f'{x:.3f}' for x in unsharded_walls['config4'][1])}"
          f" s); peak memory {out[4] / 2**30:.2f} GiB; launches {launches19}",
          flush=True)
    del pr, sw, again, other, out

    # 4. span_pipeline at 2^24: 4 microbatches through one span of config
    # 2's fiber, adaptive, with ASE on injected draws
    rng = np.random.default_rng(190)
    batch19 = torch.stack([torch.roll(A0, 4099 * k) for k in range(4)])
    draws = [[rng.standard_normal((2, n_full), dtype=np.float32)]
             for n_full in [A0.numel()] * 4]
    kernels.reset_launches()
    t0 = time.perf_counter()
    sp = span_pipeline(batch19, smesh, params.fs, 50.0, alpha=0.2,
                       beta_2=-21.0, gamma=1.3, h=None, phi_max=0.01, NF=5.0,
                       noise=draws)
    torch.cuda.synchronize()
    t_sp = time.perf_counter() - t0
    launches_sp = dict(kernels.LAUNCHES)
    sigma = noise_ops.ase_sigma(10.0, 5.0, 299792458.0 / 1550e-9, params.fs)
    errs = []
    for k in range(4):
        y, _ = ssfm.ssfm_propagate(batch19[k], w, 50.0, alpha=0.2,
                                   beta_2=-21.0, gamma=1.3, phi_max=0.01)
        d_k = torch.as_tensor(draws[k][0], device=dev) * float(
            np.float32(sigma))
        y = y * float(np.float32(10.0 ** 0.5)) + torch.complex(d_k[0], d_k[1])
        errs.append(float((sp.local[k] - y).abs().max() / y.abs().max()))
    check(max(errs) <= 5e-4 and launches_sp["nl_halfstep"] > 0
          and launches_sp["cmul"] > 0, 19,
          f"span_pipeline: max abs err / peak {max(errs):.3g} > 5e-4, or "
          f"launches {launches_sp}")
    print(f"phase 19 span_pipeline (4 x 2^24 samples, 50 km adaptive + "
          f"ASE): ok err/peak {max(errs):.2g} against the spans one by one; "
          f"{t_sp:.3f} s; launches {launches_sp}; phase 19 "
          f"{time.perf_counter() - t19:.1f} s", flush=True)
    del sp, batch19, draws, y, d_k
    dist.destroy_process_group()
    rendezvous.cleanup()
    del A0

    # ---- phase 20: the staged leftovers at 2^24 samples ----
    st = staged_leftovers(torch, kernels, link, prbs, spec, params, dev)
    g20, g20b = st["uniform kL=2"], st["gaussian kL=8 F=10"]
    err["fbg_rk4"] = st["err"]
    ms["fbg_rk4"] = ms10["fbg_rk4"] = (g20["ms24"], g20["plain24"])
    bounds["fbg_rk4"] = g20["bound24"]
    ms["fbg_rk4_2^24_gauss"] = ms10["fbg_rk4_2^24_gauss"] = (
        g20b["ms24"], g20b["plain24"])
    bounds["fbg_rk4_2^24_gauss"] = g20b["bound24"]
    for key, g in (("fbg_rk4_2^20_512", g20), ("fbg_rk4_2^20_gauss", g20b)):
        ms[key] = ms10[key] = (g["ms20"], g["plain20"])
        bounds[key] = g["bound20"]

    by_path = {"config2": launches2, "config4": launches4,
               "staged": launches_staged, "config3_hard": launches3,
               "config3_soft": launches3s, "config5": launches5,
               "config5_defined": launches5d, "wdm_ppm": launches_wp,
               "eye": launches_eye, "resumable": launches_res,
               "span_chain": launches_chain,
               **{"sharded_" + k: v for k, v in launches_sharded.items()},
               "pipelined_config4": launches19, "span_pipeline": launches_sp,
               **st["launches"]}
    # a kernel's other shapes: config 4's 2-pol cmul, the DAC's 64 nrz taps,
    # the histograms of the sweeps, the range estimator and the density
    also = {"cmul": {"cmul_2pol": "(2, 2^24) x 1-D 2^24"},
            "fir_filter": {"fir_filter_64": "2^24 samples, 64 taps"},
            "histogram2d": hist_also,
            "fbg_rk4": {"fbg_rk4_2^24_gauss": f"2^24 bins, {g20b['n_steps']} "
                        "steps (gaussian kL = 8, F = 10); plain_ms one call",
                        "fbg_rk4_2^20_512": "2^20 bins, 512 steps (uniform "
                        "kL = 2)",
                        "fbg_rk4_2^20_gauss": f"2^20 bins, {g20b['n_steps']} "
                        "steps (gaussian kL = 8, F = 10)"}}

    def numbers(k):
        return {"ms": ms10[k][0], "plain_ms": ms10[k][1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                "library_ms": library.get(k),
                "ms_one_launch": ms[k][0], "plain_ms_one_launch": ms[k][1]}

    print(json.dumps({"kernels": [
        {"name": k, "route": REPLACES[k][0], "source": REPLACES[k][1],
         "replaces": REPLACES[k][2],
         "launches": sum(p[k] for p in by_path.values()),
         "launches_by_path": {p: c[k] for p, c in by_path.items()},
         "max_abs_err": err[k], **numbers(k),
         **({"shape": "by rows (1, 4096) eye window, 2^20 samples"}
            if k == "histogram2d" else {}),
         **({"shape": "2^24 bins, 512 steps (uniform kL = 2); plain_ms one "
                      "call"} if k == "fbg_rk4" else {}),
         **({"also": [{"shape": shape, **numbers(key)}
                      for key, shape in also[k].items()]}
            if k in also else {})}
        for k in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
