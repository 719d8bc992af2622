"""Generalized N-arm MZM transfer function on PyTorch (reference
examples/generalized_mzm_transfer_function.py); twin of
examples/generalized_mzm.py.

The generalized Mach-Zehnder interferometer with N arms and linear
phase progression n*phi sums exp(j n phi) over the arms:

    E_out = (E_in / N) * sum_{n} exp(j n phi)   (symmetric indexing)

For N=2 this reduces to the classic cos(phi/2) field transfer, which
is checked here against the device MZM at matching drive.  Larger N
sharpens the transfer toward a frequency-comb-like response (the
Dirichlet kernel |sin(N phi/2) / (N sin(phi/2))|^2).

Run:  python examples/torch/generalized_mzm.py [--device cpu] [--show]
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

from opticomlib_tpu_torch import gv
from opticomlib_tpu_torch.devices import MZM
from opticomlib_tpu_torch.signals import OpticalSignal

ap = argparse.ArgumentParser(description="generalized N-arm MZM")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the transfers")
args = ap.parse_args()


def gmzm(Ein, phi, N=2):
    """Generalized N-arm MZM field transfer (symmetric arm indexing:
    conjugate pairs exp(+-j n phi), plus the n=0 arm when N is odd)."""
    phi = np.asarray(phi, dtype=float)
    pos = (np.array([np.exp(1j * n * phi) for n in range(1, N // 2 + 1)])
           if N > 1 else np.zeros((1,) + phi.shape))
    return Ein / N * ((N % 2) + np.sum(pos + np.conj(pos), axis=0))


phi = np.linspace(-2 * np.pi, 2 * np.pi, 1000)

# N=2: arm phases +-phi -> field cos(phi) -> power cos^2(phi)
P2 = np.abs(gmzm(1.0, phi, N=2)) ** 2
err_theory = np.max(np.abs(P2 - np.cos(phi) ** 2))
print(f"N=2 vs cos^2(phi) theory: max |dP| = {err_theory:.2e}")

# ... and to the device MZM at ideal extinction: the push-pull MZM's
# field is cos(pi*u/(2*Vpi)), so its half-phase g equals gmzm's phi
gv(sps=2, R=1e9, N=500, device=args.device)
Vpi = 5.0
u = 2 * Vpi * phi / np.pi
out = MZM(OpticalSignal(np.ones(u.size, dtype=complex)), u, bias=0,
          Vpi=Vpi, loss_dB=0, ER_dB=300)
P_dev = (out.signal.abs() ** 2).reshape(-1).cpu().numpy()
err_dev = np.max(np.abs(P_dev - P2))
print(f"N=2 vs devices.MZM (ideal ER): max |dP| = {err_dev:.2e}")
assert err_theory < 1e-12 and err_dev < 1e-6

for N in (4, 10):
    PN = np.abs(gmzm(1.0, phi, N=N)) ** 2
    print(f"N={N:2d}: peak transfer {PN.max():.3f}, "
          f"FWHM {np.mean(PN > 0.5) * (phi[-1]-phi[0]) / np.pi:.2f} pi")

if args.show:
    import matplotlib.pyplot as plt
    for N, style in ((2, "r--"), (4, "b--"), (10, "y--")):
        plt.plot(phi / np.pi, np.abs(gmzm(1.0, phi, N=N)) ** 2, style,
                 label=f"N={N}")
    plt.grid(alpha=0.3)
    plt.title("Generalized MZM power transfer")
    plt.xlabel(r"$\phi/\pi$")
    plt.ylabel(r"$|E_{out}/E_{in}|^2$")
    plt.legend()
    plt.tight_layout()
    plt.show()
