"""Higher-order SSFM schemes on PyTorch: accuracy per FFT; twin of
examples/higher_order_ssfm.py.

Propagates a Gaussian pulse 40 km and compares the reference 2nd-order
frozen-operator scheme, the 4th-order Yoshida composition, and Sinkin
local-error adaptive stepping against a fine-step oracle, reporting the
error each achieves per FFT pair spent.  The field stays on the card: every
kick and spectral product is the port's hand-written kernel.

Run: python examples/torch/higher_order_ssfm.py [--device cpu]
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
import torch

from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.params import check_device

ap = argparse.ArgumentParser(description="higher-order split-step schemes")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
dev = check_device(args.device)

n, fs, p0 = 4096, 640e9, 0.05
t = np.arange(n) / fs
A = torch.as_tensor((np.sqrt(p0) * np.exp(-(((t - t.mean()) / 15e-12) ** 2)
                                          / 2)).astype(np.complex64),
                    device=dev)
w = 2 * np.pi * np.fft.fftfreq(n) * fs
cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
L = 40.0

oracle, _ = ssfm.ssfm_scan_o4(A, w, L, h=L / 1024, **cfg)


def err(x):
    return float(torch.linalg.vector_norm(x - oracle)
                 / torch.linalg.vector_norm(oracle))


print(f"{'scheme':<28}{'FFT pairs':>10}{'rel. error':>14}")
for h_div in (16, 64):
    out, _ = ssfm.ssfm_propagate(A, w, L, h=L / h_div, **cfg)
    print(f"{'reference o2, h=L/%d' % h_div:<28}{h_div:>10}{err(out):>14.2e}")
for h_div in (4, 16):
    out, _ = ssfm.ssfm_scan_o4(A, w, L, h=L / h_div, **cfg)
    print(f"{'Yoshida o4,   h=L/%d' % h_div:<28}{3 * h_div:>10}"
          f"{err(out):>14.2e}")
for tol in (1e-3, 1e-4):
    out, steps = ssfm.ssfm_local_error(A, w, L, tol=tol, **cfg)
    print(f"{'local error, tol=%.0e' % tol:<28}{3 * steps:>10}"
          f"{err(out):>14.2e}")
for tol in (1e-4, 1e-6):
    out, _ = ssfm.ssfm_o4_auto(A, w, L, tol=tol, **cfg)
    print(f"{'o4 auto,     tol=%.0e' % tol:<28}{'(self)':>10}"
          f"{err(out):>14.2e}")

# the self-tuning o4 is what FIBER(method="o4") / FiberSpec(method="o4")
# run when no fixed h is given: no calibration script needed
from opticomlib_tpu_torch import gv  # noqa: E402
from opticomlib_tpu_torch.devices import DBP, FIBER  # noqa: E402
from opticomlib_tpu_torch.signals import OpticalSignal  # noqa: E402

gv(sps=16, R=10e9, N=n // 16, device=dev)
fwd = FIBER(OpticalSignal(A), length=L, method="o4", tol=1e-5, **cfg)
back = DBP(fwd, length=L, method="o4", tol=1e-5, **cfg)
rt = float(torch.linalg.vector_norm(back.signal - A)
           / torch.linalg.vector_norm(A))
print(f"\nFIBER/DBP method='o4' (self-tuning) round trip: {rt:.2e}")
