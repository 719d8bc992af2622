#!/usr/bin/env python3
"""Sweep the tile constants of the port's cmul and fir_filter kernels on a card.

    python3 scripts/sweep_torch_kernels.py

Writes variants of ``opticomlib_tpu_torch/ops/csrc/{cmul,fir_filter}.cu`` to
``build/sweep/`` (the constants replaced in the text: threads a CTA, vectors
a thread, CTAs an SM; for ``cmul`` also streaming loads and stores,
``__ldcs``/``__stcs``, in place of plain ones), builds them all at once with
the port's own ``nvcc`` flags, holds each to the kernel as committed bit for
bit, and times each kernel alone (through ctypes, outputs allocated
beforehand, median of 40 launches with CUDA events, two rounds) at the
paths' shapes: ``cmul`` at 2^24 samples, same shape and (2, 2^24) x 1-D,
beside ``torch.mul``; ``fir_filter`` at 2^24 samples with 783, 64, 16 and
8192 taps.  Needs a CUDA card and ``nvcc``; prints the card's name and power
limit first.
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
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
STREAMING = [(r"= ([ab])\[off\];", r"= __ldcs(\1 + off);"),
             (r"c\[off\] = (cmul2\(av\[k\], bv\[k\]\));",
              r"__stcs(c + off, \1);")]


def variants():
    """``{tag: (source name, [(pattern, replacement), ...])}``; an empty list
    is the kernel as committed."""
    out = {"cmul": ("cmul", []), "fir": ("fir_filter", [])}
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
        if tag.startswith("cmul"):
            lib.cmul_launch.argtypes = [P, P, P, LL, LL, I, P]
        else:
            lib.fir_launch.argtypes = [P, P, P, LL, I, P]
        libs[tag] = lib
    return libs


def ms(fn, reps=40):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build_all(variants())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
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
    del A, E, A2, C, C2, want, want2

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
