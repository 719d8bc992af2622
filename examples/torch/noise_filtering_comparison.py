"""Bessel vs ideal brick-wall noise filtering on PyTorch (reference
examples/noise_filtering_comparison.py); twin of
examples/noise_filtering_comparison.py.

Passes white Gaussian noise of a set spectral density through (a) the
zero-phase 4th-order Bessel LPF device and (b) an ideal square filter of
the same cutoff, then compares the output powers against the
noise-equivalent-bandwidth prediction and the Welch PSDs in the
passband.  The noise is drawn on the host from the same seeded generator
as the JAX script, so both packages filter the same samples.

Run:  python examples/torch/noise_filtering_comparison.py [--device cpu]
      [--show]
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
import scipy.signal as sg
import torch

from opticomlib_tpu_torch import dbm, gv, idbm
from opticomlib_tpu_torch.devices import LPF
from opticomlib_tpu_torch.signals import electrical_signal

ap = argparse.ArgumentParser(description="Bessel vs brick-wall filtering")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the PSDs")
args = ap.parse_args()

gv(sps=16, R=10e9, N=100_000, device=args.device)

noise_power = -150  # dBm/Hz
rng = np.random.default_rng(5)
noise = electrical_signal(rng.normal(
    0, np.sqrt(idbm(noise_power) * gv.fs), gv.N * gv.sps))

noise_bessel = LPF(noise, BW=gv.R)


def ideal_square_filter(signal, BW):
    X = torch.fft.fft(signal.signal)
    df = gv.fs / signal.size
    cutoff_bin = int(BW / df)
    Y = torch.zeros_like(X)
    Y[:cutoff_bin] = X[:cutoff_bin]
    Y[-cutoff_bin:] = X[-cutoff_bin:]
    return electrical_signal(torch.fft.ifft(Y).real)


noise_square = ideal_square_filter(noise, BW=gv.R)

P_b = float(noise_bessel.power())
P_s = float(noise_square.power())
P_pred = idbm(noise_power) * 2 * gv.R  # two-sided brick wall
print(f"input density: {noise_power} dBm/Hz, cutoff {gv.R/1e9:.0f} GHz")
print(f"  brick-wall output power: {dbm(P_s):7.2f} dBm "
      f"(prediction {dbm(P_pred):7.2f} dBm)")
print(f"  Bessel output power:     {dbm(P_b):7.2f} dBm "
      f"(NEB ratio {P_b / P_s:.3f})")
assert abs(dbm(P_s) - dbm(P_pred)) < 0.3

if args.show:
    import matplotlib.pyplot as plt
    nperseg = 512
    for sig, label in ((noise, "AWG noise"),
                       (noise_bessel, "Bessel filtered"),
                       (noise_square, "ideal square filtered")):
        f, psd = sg.welch(sig.signal.real.cpu().numpy(), fs=gv.fs,
                          nperseg=nperseg, return_onesided=False,
                          noverlap=int(0.75 * nperseg),
                          scaling="density", detrend=False, window="hann")
        plt.plot(np.fft.fftshift(f) / 1e9,
                 dbm(np.fft.fftshift(psd)), lw=2, label=label)
    plt.xlabel("Frequency (GHz)")
    plt.ylabel("PSD (dBm/Hz)")
    plt.ylim(noise_power - 10, noise_power + 2)
    plt.xlim(-20, 20)
    plt.legend()
    plt.grid(alpha=0.3)
    plt.show()
