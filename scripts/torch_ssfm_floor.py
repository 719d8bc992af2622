#!/usr/bin/env python3
"""Round-off floor of the split-step schemes of examples/torch/higher_order_ssfm.py.

    python3 scripts/torch_ssfm_floor.py [--device cuda|cpu]

The example prints each scheme's error against a float32 oracle (Yoshida o4
at h = L/1024, 3072 FFT pairs) run on the same device.  This script runs the
example's pulse, fiber and schemes on ``--device`` (default: the card) in
complex64, and once more on the host in complex128 with the plain ops (the
float64 oracle), and prints for each scheme its error against the float32
oracle, against the float64 oracle, and against the same scheme in float64.

Each float32 run is made four times, each changing one thing:

* ``kernels``: the port's path (the kicks and products are its kernels);
* ``plain``: ``kernels.nl_halfstep``, ``kernels.strang_kicks`` and
  ``kernels.cmul`` replaced by their plain PyTorch versions on the same
  device;
* ``host_factor``: the linear factor ``exp(-alpha h/2 + i phi(w) h)`` made
  on the host and copied to the device;
* ``host_fft``: every FFT made on the host and copied back.

On the CPU the last two change nothing and are left out.  The last line is
one JSON object with every error.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton"))

from opticomlib_tpu_torch.ops import kernels, ssfm  # noqa: E402

N, FS, P0 = 4096, 640e9, 0.05
CFG = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
L = 40.0
_ORIG = dict(nl=kernels.nl_halfstep, kicks=kernels.strang_kicks,
             cmul=kernels.cmul,
             lin=ssfm._lin_factor, fft=torch.fft.fft, ifft=torch.fft.ifft)


def _lin64(phi_w, alpha, h):
    th = phi_w.double() * float(h)
    return torch.polar(torch.full_like(th, np.exp(-0.5 * float(alpha)
                                                  * float(h))), th)


def _set(mode: str) -> None:
    """Swap the pieces ``mode`` changes; ``kernels`` restores all."""
    kernels.nl_halfstep, kernels.cmul = _ORIG["nl"], _ORIG["cmul"]
    kernels.strang_kicks = _ORIG["kicks"]
    ssfm._lin_factor = _ORIG["lin"]
    torch.fft.fft, torch.fft.ifft = _ORIG["fft"], _ORIG["ifft"]
    if mode in ("plain", "float64"):
        kernels.nl_halfstep = (lambda A, c, out=None:
                               kernels.nl_halfstep_ref(A, c))
        kernels.strang_kicks = (lambda A, s, c1, c2=None, out=None:
                                kernels.strang_kicks_ref(A, s, c1, c2))
        kernels.cmul = lambda A, B, out=None: kernels.cmul_ref(A, B)
    if mode == "float64":
        ssfm._lin_factor = _lin64
    if mode == "host_factor":
        ssfm._lin_factor = (lambda phi_w, alpha, h: _ORIG["lin"](
            phi_w.cpu(), alpha, h).to(phi_w.device))
    if mode == "host_fft":
        torch.fft.fft = (lambda x, dim=-1, **k: _ORIG["fft"](
            x.cpu(), dim=dim, **k).to(x.device))
        torch.fft.ifft = (lambda x, dim=-1, **k: _ORIG["ifft"](
            x.cpu(), dim=dim, **k).to(x.device))


def schemes(A: torch.Tensor) -> dict:
    """The example's oracle and eight schemes on ``A``, as complex128 on the
    host."""
    w = 2 * np.pi * np.fft.fftfreq(N) * FS
    out = {"oracle": ssfm.ssfm_scan_o4(A, w, L, h=L / 1024, **CFG)[0]}
    for d in (16, 64):
        out[f"reference o2, h=L/{d}"] = ssfm.ssfm_propagate(
            A, w, L, h=L / d, **CFG)[0]
    for d in (4, 16):
        out[f"Yoshida o4, h=L/{d}"] = ssfm.ssfm_scan_o4(
            A, w, L, h=L / d, **CFG)[0]
    for tol in (1e-3, 1e-4):
        out[f"local error, tol={tol:.0e}"] = ssfm.ssfm_local_error(
            A, w, L, tol=tol, **CFG)[0]
    for tol in (1e-4, 1e-6):
        out[f"o4 auto, tol={tol:.0e}"] = ssfm.ssfm_o4_auto(
            A, w, L, tol=tol, **CFG)[0]
    return {k: v.cpu().to(torch.complex128) for k, v in out.items()}


def rel(x, y) -> float:
    return float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    if dev == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device (use --device cpu)")
    t = np.arange(N) / FS
    a0 = np.sqrt(P0) * np.exp(-(((t - t.mean()) / 15e-12) ** 2) / 2)
    _set("float64")
    ref = schemes(torch.as_tensor(a0.astype(np.complex128)))
    result = {"device": dev, "name": (torch.cuda.get_device_name(0)
                                      if dev == "cuda" else "cpu")}
    modes = ["kernels", "plain"] + (["host_factor", "host_fft"]
                                    if dev != "cpu" else [])
    for mode in modes:
        _set(mode)
        t0 = time.perf_counter()
        got = schemes(torch.as_tensor(a0.astype(np.complex64), device=dev))
        wall = time.perf_counter() - t0
        row = {"oracle32_vs_oracle64": rel(got["oracle"], ref["oracle"])}
        print(f"== {dev} {mode} ({wall:.1f} s): float32 oracle against the "
              f"float64 oracle {row['oracle32_vs_oracle64']:.3e}")
        for k, v in got.items():
            if k == "oracle":
                continue
            row[k] = (rel(v, got["oracle"]), rel(v, ref["oracle"]),
                      rel(v, ref[k]))
            print(f"  {k:<26} vs float32 oracle {row[k][0]:.3e}  vs float64 "
                  f"oracle {row[k][1]:.3e}  vs itself in float64 "
                  f"{row[k][2]:.3e}", flush=True)
        result[mode] = row
    _set("kernels")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
