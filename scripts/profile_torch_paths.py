#!/usr/bin/env python3
"""Where the time of the port's receiver paths goes, on one card.

    python3 scripts/profile_torch_paths.py [hist] [config3] [config5] [eye] [sharded] [link_sharded]

Profiles, with ``torch.profiler`` (CPU and CUDA activities), one steady call
(after one warm-up call) of each named path at the sizes of
``chip_smoke.py``: ``config3`` (``dsp_ppm`` hard and soft, 2^24 samples),
``config5`` (``dsp_wdm(16)``, 16 x 2^24 samples), ``eye`` (config 2's
``LinkProgram.eye`` and ``dsp``, 2^24 samples); and ``hist``: twenty calls in
a row of each histogram wrapper at (1, 4096) over 2^20 eye-like samples, by
rows and by pairs, with the host time of the wrapper itself (``cProfile``);
``sharded``: config 2's 50 km fiber at 2^24 samples through ``ssfm_sharded``
at world size 1 over NCCL (pencil adaptive, pencil and overlap at a fixed
1 km step) beside the unsharded steps on a phase grid kept on the card;
``link_sharded``: the sharded fused link at world size 1 over NCCL, config
5's ``dsp_wdm(16)`` (16 x 2^24 samples) and config 2's ``dsp``, with the
peak device memory of the config-5 call, of its chain and of each of its
stages.
For each it prints the wall time, the device's busy time and idle share
(the union of the kernels' and copies' intervals against the wall time), and
the device time by kernel name.  With no argument it profiles the first
four.
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

import chip_smoke as cs  # noqa: E402
from opticomlib_tpu_torch import link  # noqa: E402
from opticomlib_tpu_torch.ops import kernels  # noqa: E402
from opticomlib_tpu_torch.ops.prbs import prbs  # noqa: E402
from opticomlib_tpu_torch.params import SimParams  # noqa: E402
from opticomlib_tpu_torch.utils import profiling  # noqa: E402


def profiled(label, fn, top=12):
    """Profile one ``fn()`` after one warm-up; prints as it goes."""
    return profiling.profiled(label, fn, top=top,
                              out=lambda line: print(line, flush=True))


def main():
    which = set(sys.argv[1:]) or {"hist", "config3", "config5", "eye"}
    if not which <= {"hist", "config3", "config5", "eye", "sharded",
                     "link_sharded"}:
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

    if "sharded" in which:
        import tempfile

        import numpy as np
        import torch.distributed as dist

        from opticomlib_tpu_torch.ops import ssfm
        from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                                   make_link_mesh,
                                                   ssfm_sharded)
        params = SimParams.create(sps=cs.SPS, R=cs.R, _warn=False)
        A0 = torch.polar(0.2 * torch.rand(2**24, generator=g, device="cuda"),
                         torch.zeros(2**24, device="cuda")).contiguous()
        w = 2 * np.pi * np.fft.fftfreq(2**24) * params.fs
        phi = torch.as_tensor(ssfm.dispersion_phase(w, -21.0, 0.0),
                              device="cuda")
        a_km, fib = ssfm.alpha_per_km(0.2), dict(alpha=0.2, beta_2=-21.0,
                                                 gamma=1.3)
        hs = ssfm.ssfm_step_schedule(50.0, 1.0)
        with tempfile.TemporaryDirectory() as tmp:
            initialize_multihost(f"file://{tmp}/rendezvous", 1, 0)
            mesh = make_link_mesh(1, 1)
            h0 = min(np.float32(0.01) / (np.float32(1.3) * ssfm.max_power(
                A0)), np.float32(50.0))
            profiled("unsharded steps, adaptive", lambda: ssfm.ssfm_while_inside(
                A0, phi, 50.0, 1.3, 0.01, h0, a_km, adaptive=True))
            profiled("sharded pencil, adaptive", lambda: ssfm_sharded(
                A0, mesh, params.fs, 50.0, h=None, phi_max=0.01, **fib))
            profiled("unsharded steps, h = 1 km", lambda: ssfm.ssfm_scan_inside(
                A0, phi, hs, 1.3, a_km))
            profiled("sharded pencil, h = 1 km", lambda: ssfm_sharded(
                A0, mesh, params.fs, 50.0, h=1.0, **fib))
            profiled("sharded overlap, h = 1 km", lambda: ssfm_sharded(
                A0, mesh, params.fs, 50.0, h=1.0, method="overlap", **fib))
            dist.destroy_process_group()

    if "link_sharded" in which:
        import tempfile

        import torch.distributed as dist

        from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                                   make_link_mesh)
        spec = cs.config2_spec(link)
        params5 = SimParams.create(sps=cs.SPS5, R=cs.R, _warn=False)
        bits5 = prbs(23, length=cs.N_CH5 * cs.N_BITS5)[0].reshape(
            cs.N_CH5, -1)
        with tempfile.TemporaryDirectory() as tmp:
            initialize_multihost(f"file://{tmp}/rendezvous", 1, 0)
            mesh = make_link_mesh(1, 1)
            prog = link.build_link(spec, cs.N_BITS5, params5, mesh=mesh)
            profiled("sharded config 5 dsp_wdm(16)", lambda: prog.dsp_wdm(
                cs.N_CH5, bits=bits5, seed=5))
            # peak device memory, lap by lap: up to each stage, in it, the
            # photodiode and LPF after the stages, the receivers
            laps = []

            def lap(label):
                torch.cuda.synchronize()
                laps.append((label, torch.cuda.max_memory_allocated()))
                torch.cuda.reset_peak_memory_stats()

            # the link chain's own seams (link._LinkChain)
            stage, receive = prog._stage, prog._receive

            def staged(f, st, cc, *a):
                lap(f"before the {cc['kind']} stage")
                out = stage(f, st, cc, *a)
                lap(f"the {cc['kind']} stage")
                return out

            def received(*a):
                out = receive(*a)
                lap("photodiode, LPF")
                return out

            prog._stage, prog._receive = staged, received
            lap("(reset)")
            prog.dsp_wdm(cs.N_CH5, bits=bits5, seed=5)
            lap("receivers")
            for label, peak in laps[1:]:
                print(f"    peak {label}: {peak / 2**30:.2f} GiB", flush=True)
            del prog
            prog = link.build_link(spec, cs.N_BITS, SimParams.create(
                sps=cs.SPS, R=cs.R, _warn=False), mesh=mesh)
            bits = prbs(15, length=cs.N_BITS)[0]
            profiled("sharded config 2 dsp", lambda: prog.dsp(bits=bits,
                                                               seed=3))
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
