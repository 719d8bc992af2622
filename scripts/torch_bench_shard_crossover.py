#!/usr/bin/env python3
"""Pencil FFT against overlap-save for the sharded split-step fiber, on
``opticomlib_tpu_torch`` (the twin of ``scripts/bench_shard_crossover.py``).

    python3 scripts/torch_bench_shard_crossover.py [--ranks W]
        [--device cuda|cpu] [--sizes 20,22,24] [--reps 3] [--out PATH]

Starts ``W`` ranks (default 1), one a card over NCCL (``--device cuda``, the
default: it needs ``W`` cards) or one a CPU process over gloo, joined
through ``tcp://127.0.0.1:<a free port>``, with a ``('wdm', 'time')`` mesh
of 1 x W (``make_link_mesh``).  On the JAX script's cells, n in 2^sizes
for two shapes of 12 km fiber (config-2-like at h = 1.0 km, the larger halo;
config-4-span-like at h = 0.5 km), it times ``parallel.fiber.ssfm_sharded``
with ``method="pencil"`` (a distributed FFT each linear step: two
all-to-alls a transform) and ``method="overlap"`` (local FFTs of ``block +
2H`` samples and a halo exchange with the ring neighbours): the field
sharded once, then the least wall time over ``reps`` calls after one
warm-up, each call to every rank's completion (a synchronisation and a
barrier).  Rank 0 writes ``--out`` (default ``CROSSOVER_CUDA.json`` at the
repository root) with the world size and the device.

The crossover this measures is a cost between cards: at world size 1 every
collective sees one rank and moves nothing, so the numbers mean nothing
for ``AUTO_HALO_FRAC`` (``parallel/fiber.py``, left at 0.0) until the run
has two or more cards.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FS = 10e9 * 64
#: per-step cost is what crosses over, so short spans at the same h measure
#: the same ratio with fewer steps (12 / 24 steps a call)
SHAPES = {
    "config2": dict(length=12.0, alpha=0.2, beta_2=-21.0, gamma=1.3, h=1.0),
    "config4_span": dict(length=12.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                         h=0.5),
}


def cells(mesh, world: int, sizes, reps: int, torch, dist) -> list:
    """Every (size, shape) cell timed for both methods on this rank."""
    from opticomlib_tpu_torch.parallel.fiber import (shard_waveform,
                                                     ssfm_sharded)
    from opticomlib_tpu_torch.parallel.halo import halo_width

    def done():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()

    rows = []
    for log2n in sizes:
        n = 1 << log2n
        rng = np.random.default_rng(7)
        A0 = ((rng.normal(size=n) + 1j * rng.normal(size=n))
              .astype(np.complex64) * np.sqrt(0.01))
        field = shard_waveform(A0, mesh)
        for shape, kw in SHAPES.items():
            block = n // world
            H = halo_width(kw["h"], kw["beta_2"], 0.0, FS)
            row = {"n_log2": log2n, "shape": shape, "halo_H": H,
                   "block": block, "halo_frac": round(2 * H / block, 4)}
            for method in ("pencil", "overlap"):
                def run():
                    out = ssfm_sharded(field, mesh, fs=FS, method=method,
                                       **kw)
                    done()
                    return out

                steps = run().n_steps  # warm-up
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    run()
                    times.append(time.perf_counter() - t0)
                row[method] = {"wall_s": round(min(times), 4),
                               "samples_per_s": round(n / min(times), 1),
                               "n_steps": steps}
            row["overlap_speedup"] = round(
                row["pencil"]["wall_s"] / row["overlap"]["wall_s"], 3)
            rows.append(row)
            if dist.get_rank() == 0:
                print(f"[crossover] n=2^{log2n} {shape:13s} "
                      f"2H/block={row['halo_frac']:.4f}  pencil "
                      f"{row['pencil']['wall_s']:8.4f}s  overlap "
                      f"{row['overlap']['wall_s']:8.4f}s  "
                      f"overlap_speedup={row['overlap_speedup']}",
                      flush=True)
    return rows


def rank_main(a) -> None:
    import torch
    import torch.distributed as dist

    from opticomlib_tpu_torch.parallel import initialize_multihost
    from opticomlib_tpu_torch.parallel.fiber import make_link_mesh

    if a.device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(f"tcp://127.0.0.1:{a.port}", a.ranks, a.rank,
                         device=a.device, timeout_s=600)
    mesh = make_link_mesh(n_wdm=1, n_time=a.ranks)
    rows = cells(mesh, a.ranks, [int(s) for s in a.sizes.split(",")],
                 a.reps, torch, dist)
    if a.rank == 0:
        device = {"type": a.device, "torch": torch.__version__,
                  "cuda": torch.version.cuda}
        if a.device == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip().splitlines()
            device.update(cards=smi,
                          name=torch.cuda.get_device_name(mesh.device))
        out = {"backend": dist.get_backend(), "world_size": a.ranks,
               "device": device, "fs": FS, "reps": a.reps, "cells": rows,
               "method": "least wall over reps after one warm-up, the field "
                         "sharded once before; each call to every rank's "
                         "completion (synchronize and barrier); halo_frac "
                         "= 2H/block",
               "note": "a cost between cards: at world size 1 every "
                       "collective sees one rank, and the crossover means "
                       "nothing until the run has two or more cards"}
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"[crossover] wrote {a.out}", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sizes", default="20,22,24",
                    help="log2 of the sample counts (default 20,22,24)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "CROSSOVER_CUDA.json"))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if os.path.abspath(a.out) == os.path.join(ROOT, "CROSSOVER.json"):
        ap.error("CROSSOVER.json is the JAX package's record; give another "
                 "--out")
    if a.rank is not None:
        rank_main(a)
        return 0
    if a.device == "cuda":
        import torch
        if torch.cuda.device_count() < a.ranks:
            print(f"{a.ranks} ranks need {a.ranks} cards, have "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
    a.out = os.path.abspath(a.out)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--ranks", str(a.ranks), "--port", str(port), "--device", a.device,
         "--sizes", a.sizes, "--reps", str(a.reps), "--out", a.out],
        env=dict(os.environ, LOCAL_RANK=str(r))) for r in range(a.ranks)]
    try:
        rcs = [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
