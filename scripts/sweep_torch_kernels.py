#!/usr/bin/env python3
"""Sweep the tile constants of the port's cmul, fir_filter and histogram2d
kernels, and of the Triton boundary pass strang_kicks, on a card.

    python3 scripts/sweep_torch_kernels.py [cmul] [fir] [hist] [kicks]

Writes variants of ``opticomlib_tpu_torch/ops/csrc/{cmul,fir_filter,
histogram2d}.cu`` to ``build/sweep/`` (the constants replaced in the text:
threads a CTA, vectors a thread, CTAs an SM; for ``cmul`` also streaming
loads and stores, ``__ldcs``/``__stcs``, in place of plain ones; for the
histograms blocks an SM, threads, loads in flight, bins a tile, private
sub-tables a block and warp aggregation), builds them all at once with the
port's own ``nvcc`` flags, holds each to the kernel as committed bit for bit
(the histograms: to exact counts), and times each kernel alone (through
ctypes, outputs allocated beforehand, median of 40 launches with CUDA
events, two rounds; the histograms ten launches in a row, a launch being
a few microseconds) at the paths' shapes: ``cmul`` at 2^24 samples, same
shape and (2, 2^24) x 1-D, beside ``torch.mul``; ``fir_filter`` at 2^24
samples with 783, 64, 16 and 8192 taps; the histograms by rows at (1, 4096)
over 2^20 samples and (16, 4096) over 16 x 2^20, each on a real eye window
(config 2's receiver input) and on uniform bins, and by pairs at (256, 256)
over 2^22 and (16, 8192) over 16 x 2^20.  ``kicks`` launches the Triton
``_strang_kicks_kernel`` at each block size and warp count on config 4's
(2, 2^24) field with two kicks, in place, each held bit for bit to the
launch as committed (median of 20 times of ten launches in a row).  With
no argument it sweeps all four.  Needs a CUDA card and ``nvcc`` (Triton
for ``kicks``); prints the card's name and power limit first.
"""
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from opticomlib_tpu_torch.ops import _build, pulses  # noqa: E402

CSRC = ROOT / "opticomlib_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "sweep"
STREAMING = [(r"= ([ab])\[off\];", r"= __ldcs(\1 + off);"),
             (r"c\[off\] = (cmul2\(av\[k\], bv\[k\]\));",
              r"__stcs(c + off, \1);")]


def variants():
    """``{tag: (source name, [(pattern, replacement), ...])}``; an empty list
    is the kernel as committed."""
    out = {"cmul": ("cmul", []), "fir": ("fir_filter", []),
           "hist": ("histogram2d", [])}
    for name, values in [("kBlocksPerSm", (1, 3, 4, 8)),
                         ("kThreads", (128, 256, 1024)),
                         ("kUnroll", (1, 2, 8)),
                         ("kTileBins", (4096, 8192, 32768)),
                         ("kSubTables", (2, 4))]:
        for val in values:
            out[f"hist {name} {val}"] = ("histogram2d", [
                (rf"{name} = \d+;", f"{name} = {val};")])
    out["hist aggregate"] = ("histogram2d", [
        (r"kAggregate = false;", "kAggregate = true;")])
    out["hist aggregate, 8 blocks an SM"] = ("histogram2d", [
        (r"kAggregate = false;", "kAggregate = true;"),
        (r"kBlocksPerSm = \d+;", "kBlocksPerSm = 8;")])
    out["hist 4 blocks an SM, 256 threads"] = ("histogram2d", [
        (r"kBlocksPerSm = \d+;", "kBlocksPerSm = 4;"),
        (r"kThreads = \d+;", "kThreads = 256;")])
    out["hist 1 block an SM, 1024 threads"] = ("histogram2d", [
        (r"kBlocksPerSm = \d+;", "kBlocksPerSm = 1;"),
        (r"kThreads = \d+;", "kThreads = 1024;")])
    for t, v in [(512, 1), (512, 2), (256, 2), (256, 4), (256, 8), (128, 4),
                 (1024, 2)]:
        tile = [(r"kThreads = \d+;", f"kThreads = {t};"),
                (r"kVec = \d+; ", f"kVec = {v}; ")]
        out[f"cmul {t}x{v}"] = ("cmul", tile)
        out[f"cmul {t}x{v} streaming"] = ("cmul", tile + STREAMING)
    for t, c in [(64, 16), (128, 8), (128, 12), (128, 16), (256, 4),
                 (512, 2)]:
        out[f"fir {t} threads, {c} CTAs"] = ("fir_filter", [
            (r"kThreads = \d+;", f"kThreads = {t};"),
            (r"kMinCtas = \d+;", f"kMinCtas = {c};")])
    return out


def build_all(jobs):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (tag, (name, subs)) in enumerate(jobs.items()):
        text = (CSRC / f"{name}.cu").read_text()
        for pat, repl in subs:
            text, n = re.subn(pat, repl, text)
            if not n:
                raise SystemExit(f"{tag}: pattern {pat!r} not in {name}.cu")
        src, so = OUT / f"v{i}_{name}.cu", OUT / f"v{i}_{name}.so"
        src.write_text(text)
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{log}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"built {tag}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.ENTRY_POINTS[jobs[tag][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
        libs[tag] = lib
    return libs


def ms(fn, reps=40, inner=1):
    """Median over ``reps`` of the time of one ``fn()``, CUDA events around
    ``inner`` calls in a row."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def stream():
    return torch.cuda.current_stream().cuda_stream


def cmul(lib, A, B, C):
    ncol = A.shape[-1]
    err = lib.cmul_launch(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                          A.numel() // ncol, ncol, int(B.shape != A.shape),
                          stream())
    assert err == 0, err
    return C


def fir(lib, x, h, y):
    err = lib.fir_launch(x.data_ptr(), h.data_ptr(), y.data_ptr(), x.numel(),
                         h.numel(), stream())
    assert err == 0, err
    return y


def hist(lib, case, scratch, out):
    """One launch of a histogram case ``(y, ny)`` (by rows) or
    ``(t, y, nt, ny)`` (by pairs) into ``out``."""
    if len(case) == 2:
        y, ny = case
        err = lib.histogram_rows_launch(
            y.data_ptr(), y.shape[0], y.shape[1], ny, scratch.data_ptr(),
            scratch.numel(), out.data_ptr(), 0, stream())
    else:
        t, y, nt, ny = case
        err = lib.histogram2d_launch(
            t.data_ptr(), y.data_ptr(), y.numel(), nt, ny, scratch.data_ptr(),
            scratch.numel(), out.data_ptr(), 0, stream())
    assert err == 0, err
    return out


def eye_window_bins(dev):
    """The KDE bin indices of config 2's receiver at 2^20 samples (8192 eye
    slots resampled to 128): the (1, 2^20) int32 input of the main paths'
    histogram, caught at the wrapper the metrology calls."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.ops import eyeana, kernels
    from opticomlib_tpu_torch.ops.prbs import prbs
    from opticomlib_tpu_torch.params import SimParams
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0, pulse_shape="gaussian",
        loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        stages=(link.FiberSpec(length=50.0, alpha=0.2, beta_2=-21.0,
                               gamma=1.3), link.EDFASpec(G=10, NF=5)))
    prog = link.build_link(spec, 2**14, SimParams.create(
        sps=64, R=10e9, _warn=False), device=dev)
    v = prog.run(bits=prbs(15, length=2**14)[0], seed=3).v.signal
    caught, wrapper = [], kernels.histogram_rows
    kernels.histogram_rows = lambda y, ny: caught.append(y) or wrapper(y, ny)
    try:
        eyeana.eye_metrics(v, sps=64, nslots=8192, sps_resamp=128)
    finally:
        kernels.histogram_rows = wrapper
    assert tuple(caught[0].shape) == (1, 2**20), caught[0].shape
    return caught[0]


def sweep_hist(libs, dev, g):
    from opticomlib_tpu_torch.ops import kernels
    eye1 = eye_window_bins(dev)
    eye16 = torch.stack([torch.roll(eye1[0], 4099 * c) for c in range(16)])

    def rand(shape, hi):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    y22 = (torch.where(torch.rand(2**22, generator=g, device=dev) > 0.5,
                       190.0, 60.0) + 6.0 * torch.randn(
                           2**22, generator=g, device=dev)).to(torch.int32)
    rows16 = torch.arange(16, device=dev, dtype=torch.int32).repeat_interleave(
        2**20)
    cases = {
        "rows (1, 4096) eye": (eye1, 4096),
        "pairs (1, 4096) eye, zero row index": (
            torch.zeros_like(eye1[0]), eye1[0], 1, 4096),
        "rows (1, 4096) uniform": (rand((1, 2**20), 4096), 4096),
        "rows (16, 4096) eye": (eye16, 4096),
        "rows (16, 4096) uniform": (rand((16, 2**20), 4096), 4096),
        "rows (16, 8192) uniform": (rand((16, 2**20), 8192), 8192),
        "pairs (256, 256) 2^22 eye-like": (rand((2**22,), 256), y22, 256,
                                           256),
        "pairs (16, 8192) 16 x 2^20": (rows16, rand((2**24,), 8192), 16,
                                       8192),
    }
    scratch = torch.zeros(2**20, dtype=torch.int32, device=dev)
    print("histograms, ms a launch (ten queued), two rounds (variant: "
          + " | ".join(cases) + ")")
    want = {k: (kernels.histogram_rows_ref(*c) if len(c) == 2
                else kernels.histogram2d_ref(*c)) for k, c in cases.items()}
    outs = {k: torch.empty_like(w) for k, w in want.items()}
    hist_libs = {t: lib for t, lib in libs.items() if t.startswith("hist")}
    for tag, lib in hist_libs.items():
        for k, c in cases.items():
            for _ in range(2):  # the second launch finds the scratch zero
                assert torch.equal(hist(lib, c, scratch, outs[k]),
                                   want[k]), (tag, k)
    rows = {}
    for _ in range(2):
        for tag, lib in hist_libs.items():
            rows.setdefault(tag, []).append([
                ms(lambda: hist(lib, c, scratch, outs[k]), inner=10)
                for k, c in cases.items()])
    for tag, r in rows.items():
        print(f"  {tag}: " + " | ".join(
            f"{a:.4f}, {b:.4f}" for a, b in zip(*r)), flush=True)


def main():
    which = set(sys.argv[1:]) or {"cmul", "fir", "hist", "kicks"}
    if not which <= {"cmul", "fir", "hist", "kicks"}:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build_all({tag: job for tag, job in variants().items()
                      if tag.split()[0] in which})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if "hist" in which:
        sweep_hist(libs, dev, g)
    if "cmul" in which:
        sweep_cmul(libs, dev, g)
    if "fir" in which:
        sweep_fir(libs, dev, g)
    if "kicks" in which:
        sweep_kicks(dev, g)


def sweep_kicks(dev, g):
    import triton
    from opticomlib_tpu_torch.ops import kernels, ssfm
    from opticomlib_tpu_torch.ops import triton_kernels as tk
    A = torch.randn((2, 2**24), generator=g, device=dev,
                    dtype=torch.complex64) * 0.1
    c1, c2 = (float(np.float32(1.3) * (np.float32(20.0) * np.float32(w)
                                       / np.float32(2)))
              for w in (ssfm._W1, ssfm._W0))
    want = kernels.strang_kicks(A, 1.0, c1, c2, out=torch.empty_like(A))

    def run(B, out, block, warps):
        tk._strang_kicks_kernel[(triton.cdiv(B.numel(), block),)](
            torch.view_as_real(B), torch.view_as_real(out), 1.0, c1, c2,
            B.numel(), TWO=True, BLOCK=block, num_warps=warps)

    print(f"strang_kicks on (2, 2^24), two kicks, ms (committed: BLOCK "
          f"{tk._KICKS_BLOCK}, {tk._KICKS_WARPS} warps)")
    for block in (256, 512, 1024, 2048):
        for warps in (1, 2, 4, 8, 16):
            if block < 32 * warps:
                continue
            out = torch.empty_like(A)
            run(A, out, block, warps)
            assert torch.equal(out, want), (block, warps)
            B = A.clone()
            t = ms(lambda: run(B, B, block, warps), reps=20, inner=10)
            print(f"  BLOCK {block}, {warps} warps: {t:.4f}", flush=True)


def sweep_cmul(libs, dev, g):
    rows = {}

    def field(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.complex64)

    A, E, A2 = field(2**24), field(2**24), field(2, 2**24)
    C, C2 = torch.empty_like(A), torch.empty_like(A2)
    want, want2 = A * E, A2 * E
    for tag, lib in libs.items():
        if tag.startswith("cmul"):
            assert torch.equal(cmul(lib, A, E, C), want), tag
            assert torch.equal(cmul(lib, A2, E, C2), want2), tag
    for _ in range(2):
        rows.setdefault("torch.mul", []).append(
            (ms(lambda: torch.mul(A, E, out=C)),
             ms(lambda: torch.mul(A2, E, out=C2))))
        for tag, lib in libs.items():
            if tag.startswith("cmul"):
                rows.setdefault(tag, []).append(
                    (ms(lambda: cmul(lib, A, E, C)),
                     ms(lambda: cmul(lib, A2, E, C2))))
    print("cmul at 2^24 samples, ms: same shape; (2, 2^24) x 1-D")
    for tag, r in rows.items():
        print(f"  {tag}: " + "; ".join(f"{a:.4f}, {b:.4f}" for a, b in r),
              flush=True)


def sweep_fir(libs, dev, g):
    rng = np.random.default_rng(0)
    taps = {783: pulses.fir_taps(pulses.gauss_pulse(60, 64).real)[0],
            64: pulses.fir_taps(pulses.nrz_pulse(60, 64))[0],
            16: rng.normal(size=16), 8192: rng.normal(size=8192)}
    x = torch.randn(2**24, generator=g, device=dev)
    y = torch.empty_like(x)
    print("fir_filter at 2^24 samples, ms (T FMA/s of the faster round)")
    for k, h in taps.items():
        hh = torch.as_tensor(np.asarray(h), dtype=torch.float32, device=dev)
        assert hh.numel() == k
        want = fir(libs["fir"], x, hh, torch.empty_like(x))
        rows = {}
        for tag, lib in libs.items():
            if tag.startswith("fir"):
                assert torch.equal(fir(lib, x, hh, y), want), (tag, k)
        for _ in range(2):
            for tag, lib in libs.items():
                if tag.startswith("fir"):
                    rows.setdefault(tag, []).append(
                        ms(lambda: fir(lib, x, hh, y)))
        for tag, r in rows.items():
            print(f"  {k} taps, {tag}: " + ", ".join(f"{t:.4f}" for t in r)
                  + f" ({k * 2**24 / min(r) / 1e9:.2f})", flush=True)


if __name__ == "__main__":
    main()
