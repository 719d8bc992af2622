"""Power spectral density of M-PPM vs OOK waveforms on PyTorch (reference
examples/ppm_vs_ook_psd_comparison.py); twin of examples/ppm_vs_ook_psd.py.

Encodes a PRBS-15 as M-PPM for M in {4, 8, 16, 32}, shapes it through
the DAC (the ``fir_filter`` kernel on the card), and estimates the Welch
PSD of each power-normalized waveform on the bit-rate-normalized frequency
axis f/Rb (Rb = R*log2(M)/M for PPM, R for OOK).  Prints the -20 dB
occupied bandwidth of each format: PPM's slot rate exceeds the bit rate
by M/log2(M), which is the bandwidth cost of its peak-power efficiency.

Run:  python examples/torch/ppm_vs_ook_psd.py [--device cpu] [--show]
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
from scipy.signal import welch

from opticomlib_tpu_torch import gv
from opticomlib_tpu_torch.devices import DAC, PRBS
from opticomlib_tpu_torch.models.ppm import PPM_ENCODER

ap = argparse.ArgumentParser(description="PSD of M-PPM against OOK")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the PSDs")
args = ap.parse_args()

gv(sps=16, R=10e9, device=args.device)
ak = PRBS(15)


def normalized(x):
    xn = x.signal.real.cpu().numpy()
    return xn / np.sqrt(np.mean(xn**2))


curves = {}
for M in [4, 8, 16, 32]:
    xn = normalized(DAC(PPM_ENCODER(ak, M)))
    f, P = welch(xn, fs=gv.fs, nperseg=1024, nfft=4096,
                 return_onesided=True, scaling="spectrum")
    Rb = gv.R * np.log2(M) / M
    curves[f"PPM M={M}"] = (f / Rb, P)

xn = normalized(DAC(ak))
f, P = welch(xn, fs=gv.fs, nperseg=1024, nfft=4096,
             return_onesided=True, scaling="spectrum")
curves["OOK"] = (f / gv.R, P)

print("-20 dB occupied bandwidth (units of the bit rate Rb):")
for name, (fn, P) in curves.items():
    above = fn[P > P.max() * 1e-2]
    print(f"  {name:9s}  {above.max():6.2f} x Rb")

if args.show:
    import matplotlib.pyplot as plt
    for name, (fn, P) in curves.items():
        plt.plot(fn, P, lw=2, label=name,
                 color="k" if name == "OOK" else None)
    plt.xlim(-0.5, 11)
    plt.xlabel("f / Rb")
    plt.ylabel("PSD")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.show()
