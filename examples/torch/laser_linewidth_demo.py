"""Laser linewidth demo on PyTorch: the PSD of a CW laser with Wiener phase
noise is Lorentzian with FWHM = linewidth (reference
examples/laser_linewidth_demo.py); twin of examples/laser_linewidth_demo.py.
Unseeded noise is legacy ``np.random`` on the host in the JAX devices'
order, so ``np.random.seed(0)`` gives both packages the same walk.

Run:  python examples/torch/laser_linewidth_demo.py [--device cpu] [--show]
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

from opticomlib_tpu_torch import dbm, get_psd, gv
from opticomlib_tpu_torch.devices import LASER

ap = argparse.ArgumentParser(description="laser linewidth")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the spectra")
args = ap.parse_args()

gv(sps=32, R=1e9, N=100_000, device=args.device)
np.random.seed(0)

nperseg = 4 * 2048
for lw in (20e6, 100e6):
    laser = LASER(P0=0, lw=lw)
    f, psd = get_psd(laser.signal.cpu().numpy(), fs=gv.fs, nperseg=nperseg)
    # measured FWHM of the Lorentzian line
    half = psd.max() / 2
    above = f[psd > half]
    fwhm = above.max() - above.min()
    print(f"lw = {lw/1e6:5.0f} MHz  ->  measured FWHM = {fwhm/1e6:6.1f} MHz")
    if args.show:
        import matplotlib.pyplot as plt
        plt.plot(f * 1e-6, dbm(psd), label=f"{lw/1e6:.0f} MHz", lw=2)

if args.show:
    import matplotlib.pyplot as plt
    plt.xlabel("Frequency [MHz]")
    plt.ylabel("PSD [dBm]")
    plt.xlim(-300, 300)
    plt.legend()
    plt.show()
