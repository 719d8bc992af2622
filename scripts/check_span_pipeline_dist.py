#!/usr/bin/env python3
"""The span pipeline across ranks against the same chain on one rank, and
the cost of one point-to-point move.

    python3 scripts/check_span_pipeline_dist.py [--ranks S] [--device cuda|cpu]

Starts ``S`` processes (default 4), one a card over NCCL (``--device
cuda``, the default: it needs ``S`` cards) or one a CPU process over gloo,
joined through ``tcp://127.0.0.1:<a free port>``, with the ``('span',)``
mesh of all of them (``make_span_mesh(S)``).  Every rank checks:

1. ``LinkMesh.ppermute``: the ring, the open chain (the first rank gets
   nothing) and a complex payload, against the moves expected;
2. ``span_pipeline_stages`` of a keyed-ASE chain (8 x (5 km fiber + 1 dB
   EDFA, NF 5 dB), ``2 S`` microbatches of 2^16 samples, 2^12 on the CPU)
   against the same segments run back to back on this rank with the same
   keys: bit-equal, since the ASE of microbatch ``m`` in segment ``s`` is
   keyed by ``(seed, m, s)`` and not by the schedule;
3. config 4 without noise (``chip_smoke.config4_spec(noisy=False)``
   without photodiode noise: 20 x 80 km + 20 DBP spans, 40 segments,
   ``40 / S`` a rank) through ``build_link(span_mesh=).dsp_wdm(2 S)`` at
   2^14 bits x 16 (2^8 on the CPU) against ``LinkProgram.dsp_wdm`` on this
   rank's device: BER equal, thresholds and ``mu1`` within rtol 1e-4.

It also times the ring ``ppermute`` of one microbatch (2^24 complex64
samples, 128 MiB, on the card; 2^16 on the CPU): the median of 10 calls,
each to the last rank's completion (a barrier after the move).  Rank 0
prints one JSON line with every rank's checks and times; the exit code is
0 only if every check passed on every rank.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ppermute_checks(mesh, r: int, S: int, torch) -> dict:
    """The ring, the open chain and a complex payload."""
    x = torch.full((5,), complex(r, -r), dtype=torch.complex64,
                   device=mesh.device)
    ring = mesh.ppermute(x, "span", [(i, (i - 1) % S) for i in range(S)])
    nxt = (r + 1) % S
    assert ring.cpu().tolist() == [complex(nxt, -nxt)] * 5, ring
    chain = mesh.ppermute(x.real.contiguous(), "span",
                          [(i, i + 1) for i in range(S - 1)])
    if r == 0:
        assert chain is None, chain
    else:
        assert chain.cpu().tolist() == [r - 1.0] * 5, chain
    return {}


def ppermute_ms(mesh, S: int, n: int, torch, dist) -> dict:
    """Median wall time of the ring move of one ``(n,)`` complex64
    microbatch, each call to every rank's completion."""
    x = torch.randn(n, dtype=torch.complex64, device=mesh.device)
    ring = [(i, (i - 1) % S) for i in range(S)]

    def once():
        y = mesh.ppermute(x, "span", ring)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        return y

    for _ in range(2):
        once()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        once()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    return {"ring_samples": n, "ring_MiB": n * 8 / 2**20, "ring_ms": ms,
            "ring_ms_all": times,
            "ring_GBps_each_way": n * 8 / (ms * 1e-3) / 1e9}


def keyed_chain_check(mesh, r: int, S: int, torch) -> dict:
    """span_pipeline_stages with keyed ASE, bit-equal to the sequential
    segment chain on this rank."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.parallel import pipeline
    fs, B, seed = 160e9, 2 * S, 11
    n = 2**16 if mesh.device.type == "cuda" else 2**12
    stages = (link.RepeatSpec(8, (link.FiberSpec(
        length=5.0, alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5),
        link.EDFASpec(G=1.0, NF=5.0))),)
    rng = np.random.default_rng(5)
    A = ((rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)))
         .astype(np.complex64) * 0.1)
    out = pipeline.span_pipeline_stages(A, mesh, fs, stages, seed=seed)
    params, any_ase, bank = pipeline._stage_segments(stages, fs, None, n)
    segs = pipeline._Segments(params, bank, n, fs, 0,
                              params["length"].size, mesh.device)
    C = B // S
    worst = 0.0
    for j in range(C):
        m = r * C + j
        x = torch.as_tensor(A[m], device=mesh.device)
        x = torch.stack([x, torch.zeros_like(x)])
        y = segs.run(x, m, seed, None)
        worst = max(worst, float((out.local[j] - y).abs().max()))
    assert any_ase and worst == 0.0, f"max abs gap {worst}"
    return {"keyed_ase_max_abs_gap": worst}


def config4_check(mesh, S: int, dev, torch) -> dict:
    """Pipelined config 4 (noiseless) against the sequential link."""
    import chip_smoke
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.params import SimParams
    spec = replace(chip_smoke.config4_spec(link, noisy=False),
                   include_thermal=False, include_shot=False)
    params = SimParams.create(sps=16, R=chip_smoke.R, _warn=False)
    nb, nch = (2**14 if dev.type == "cuda" else 2**8), 2 * S
    t0 = time.perf_counter()
    sw_p = link.build_link(spec, nb, params, span_mesh=mesh).dsp_wdm(
        nch, seed=0)
    t_p = time.perf_counter() - t0
    sw_s = link.build_link(spec, nb, params, device=dev).dsp_wdm(
        nch, bits=sw_p.tx, seed=0)
    d_th = float(np.max(np.abs(sw_p.threshold / sw_s.threshold - 1)))
    d_mu = float(np.max(np.abs(sw_p.mu1 / sw_s.mu1 - 1)))
    assert np.array_equal(sw_p.ber, sw_s.ber), (sw_p.ber, sw_s.ber)
    assert d_th <= 1e-4 and d_mu <= 1e-4, (d_th, d_mu)
    return {"config4_channels": nch, "config4_threshold_rel": d_th,
            "config4_mu1_rel": d_mu, "config4_pipelined_s": t_p}


def rank_main(r: int, S: int, port: int, device: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_span_mesh)
    if device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(f"tcp://127.0.0.1:{port}", S, r, device=device,
                         timeout_s=300)
    mesh = make_span_mesh(S)
    res = {}
    n_ring = 2**24 if device == "cuda" else 2**16
    for name, fn in (
            ("ppermute", lambda: ppermute_checks(mesh, r, S, torch)),
            ("ppermute_time", lambda: ppermute_ms(mesh, S, n_ring, torch,
                                                  dist)),
            ("keyed_ase_chain", lambda: keyed_chain_check(mesh, r, S,
                                                          torch)),
            ("config4", lambda: config4_check(mesh, S, mesh.device,
                                              torch))):
        try:
            res[name] = dict(ok=True, **fn())
        except Exception:
            res[name] = dict(ok=False, msg=traceback.format_exc()[-2000:])
        with open(os.path.join(out, f"rank{r}.json"), "w") as f:
            json.dump(res, f)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a.rank, a.ranks, a.port, a.device, a.out)
        return 0
    if a.device == "cuda":
        import torch
        if torch.cuda.device_count() < a.ranks:
            print(f"{a.ranks} ranks need {a.ranks} cards, have "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--ranks", str(a.ranks), "--port", str(port), "--device",
             a.device, "--out", out],
            env=dict(os.environ, LOCAL_RANK=str(r)))
            for r in range(a.ranks)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = {}
        for r in range(a.ranks):
            path = os.path.join(out, f"rank{r}.json")
            ranks[r] = json.load(open(path)) if os.path.exists(path) else {}
    ok = (all(rc == 0 for rc in rcs) and all(
        len(v) == 4 and all(c["ok"] for c in v.values())
        for v in ranks.values()))
    for r, v in ranks.items():
        for name, c in v.items():
            if not c["ok"]:
                print(f"rank {r} {name}:\n{c['msg']}", file=sys.stderr)
    print(json.dumps({"ok": ok, "ranks": a.ranks, "device": a.device,
                      "rcs": rcs, "by_rank": ranks}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
