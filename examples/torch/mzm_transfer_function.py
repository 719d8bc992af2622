"""MZM transfer function sweep on PyTorch (reference
examples/generalized_mzm_transfer_function.py +
mzm_transfer_function_interactive.py, non-interactive form); twin of
examples/mzm_transfer_function.py.

Sweeps the drive voltage through the device MZM and prints/plots the
power transfer curve, checking it against cos^2 theory.

Run:  python examples/torch/mzm_transfer_function.py [--device cpu] [--show]
(on the card by default; without one, and without ``--device cpu``, it
raises)
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))))
import argparse

import numpy as np

from opticomlib_tpu_torch import gv, idb
from opticomlib_tpu_torch.devices import MZM
from opticomlib_tpu_torch.signals import OpticalSignal

ap = argparse.ArgumentParser(description="MZM transfer function")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the curve")
args = ap.parse_args()

gv(sps=2, R=1e9, N=500, device=args.device)

Vpi = 5.0
u = np.linspace(-2 * Vpi, 2 * Vpi, gv.N * gv.sps)
Ein = OpticalSignal(np.ones(u.size, dtype=complex))

out = MZM(Ein, u, bias=0, Vpi=Vpi, loss_dB=0, ER_dB=40)
P = (out.signal.abs() ** 2).cpu().numpy()

# theory: P = cos^2(pi u / 2Vpi) with finite-ER floor
g = np.pi * u / (2 * Vpi)
eta = 2 * idb(-40) ** 0.5
P_theory = np.cos(g) ** 2 + (eta / 2) ** 2 * np.sin(g) ** 2
err = np.max(np.abs(P - P_theory))
print(f"max |P - cos^2 theory| = {err:.2e}")
print(f"extinction: min/max = {P.min():.2e}/{P.max():.2f} "
      f"(ER = {10*np.log10(P.max()/P.min()):.1f} dB)")

if args.show:
    import matplotlib.pyplot as plt
    plt.plot(u / Vpi, P, label="MZM device")
    plt.plot(u / Vpi, P_theory, "--", label="cos² theory")
    plt.xlabel("u / Vπ")
    plt.ylabel("P_out / P_in")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.show()
