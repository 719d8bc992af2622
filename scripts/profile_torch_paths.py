#!/usr/bin/env python3
"""Where the time of the port's receiver paths goes, on one card.

    python3 scripts/profile_torch_paths.py [hist] [config3] [config5] [eye]

Profiles, with ``torch.profiler`` (CPU and CUDA activities), one steady call
(after one warm-up call) of each named path at the sizes of
``chip_smoke.py``: ``config3`` (``dsp_ppm`` hard and soft, 2^24 samples),
``config5`` (``dsp_wdm(16)``, 16 x 2^24 samples), ``eye`` (config 2's
``LinkProgram.eye`` and ``dsp``, 2^24 samples); and ``hist``: twenty calls in
a row of each histogram wrapper at (1, 4096) over 2^20 eye-like samples, by
rows and by pairs, with the host time of the wrapper itself (``cProfile``).
For each it prints the wall time, the device's busy time and idle share
(the union of the kernels' and copies' intervals against the wall time), and
the device time by kernel name.  With no argument it profiles all four.
Needs a CUDA card and ``nvcc``; prints the card's name and power limit first.
"""
import cProfile
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opticomlib_tpu_torch import link  # noqa: E402
from opticomlib_tpu_torch.ops import kernels  # noqa: E402
from opticomlib_tpu_torch.ops.prbs import prbs  # noqa: E402
from opticomlib_tpu_torch.params import SimParams  # noqa: E402


def profiled(label, fn, top=12):
    """Profile one ``fn()`` (ended by a synchronise) after one warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:  # union of the device intervals, in microseconds
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print(f"{label}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle {1 - busy / 1e6 / wall:.1%}, "
          f"{len(spans)} device operations", flush=True)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"    {t / 1e3:9.3f} ms {c:6d} x  {name[:90]}", flush=True)


def main():
    which = set(sys.argv[1:]) or {"hist", "config3", "config5", "eye"}
    if not which <= {"hist", "config3", "config5", "eye"}:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    if "hist" in which:
        level = torch.where(torch.rand(2**20, generator=g, device="cuda")
                            > 0.5, 0.75, 0.25)
        v = level + 0.02 * torch.randn(2**20, generator=g, device="cuda")
        y = torch.where(torch.rand(2**20, generator=g, device="cuda") < 0.05,
                        torch.clamp((v * 4096).to(torch.int32), 0, 4095), -1)
        rows, zero = y.reshape(1, -1), torch.zeros_like(y)
        calls = {"histogram_rows x 20": lambda: [
                     kernels.histogram_rows(rows, 4096) for _ in range(20)],
                 "histogram2d x 20": lambda: [
                     kernels.histogram2d(zero, y, 1, 4096) for _ in range(20)],
                 "plain version x 20": lambda: [
                     kernels.histogram_rows_ref(rows, 4096)
                     for _ in range(20)]}
        for label, fn in calls.items():
            profiled(label, fn, top=6)
        for label in list(calls)[:2]:
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(50):
                calls[label]()
            prof.disable()
            torch.cuda.synchronize()
            print(f"host time of {label}, 50 times:")
            pstats.Stats(prof).sort_stats("tottime").print_stats(8)

    if "config3" in which:
        prog = link.build_link(cs.config3_spec(link), cs.N_SYM3 * cs.M3,
                               SimParams.create(sps=cs.SPS3, R=cs.R,
                                                _warn=False), device="cuda")
        bits = prbs(15, length=cs.N_SYM3 * 3)[0]
        for dec in ("hard", "soft"):
            profiled(f"config 3 dsp_ppm {dec}", lambda: prog.dsp_ppm(
                cs.M3, decision=dec, bits=bits, seed=3))
        del prog

    if "config5" in which:
        prog = link.build_link(cs.config2_spec(link), cs.N_BITS5,
                               SimParams.create(sps=cs.SPS5, R=cs.R,
                                                _warn=False), device="cuda")
        bits = prbs(23, length=cs.N_CH5 * cs.N_BITS5)[0].reshape(cs.N_CH5, -1)
        profiled("config 5 dsp_wdm(16)", lambda: prog.dsp_wdm(
            cs.N_CH5, bits=bits, seed=5))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog._sweep(bits, 5, None, 8192, None)
        torch.cuda.synchronize()
        print(f"    of which the 16 chains (wall, unprofiled): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        del prog

    if "eye" in which:
        prog = link.build_link(cs.config2_spec(link), cs.N_BITS,
                               SimParams.create(sps=cs.SPS, R=cs.R,
                                                _warn=False), device="cuda")
        bits = prbs(15, length=cs.N_BITS)[0]
        profiled("config 2 eye", lambda: prog.eye(bits=bits, seed=3,
                                                  sps_resamp=128))
        profiled("config 2 dsp", lambda: prog.dsp(bits=bits, seed=3))


if __name__ == "__main__":
    main()
