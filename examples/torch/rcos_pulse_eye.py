"""Raised-cosine pulse shaping eye diagram on PyTorch (reference
examples/rcos.py); twin of examples/rcos_pulse_eye.py.

Shapes a PRBS-9 with a beta=0.5 raised-cosine FIR through DAC (the
``fir_filter`` kernel on the card) and runs the blind eye metrology on the
result (its histograms are the ``histogram2d`` kernel); prints the
estimated eye parameters (the RC pulse's zero-ISI property shows up as
level means at 0/1 with tiny sigmas).

Run:  python examples/torch/rcos_pulse_eye.py [--device cpu] [--show]
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
from opticomlib_tpu_torch.devices import DAC, GET_EYE, PRBS

ap = argparse.ArgumentParser(description="raised-cosine eye")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the eye")
args = ap.parse_args()

beta = 0.5
gv(sps=32, R=10e9, N=511, device=args.device)

tx = PRBS(order=9)
v = DAC(tx, pulse_shape="rcos", beta=beta, rcos_type="normal")

eye = GET_EYE(v, nslots=gv.N)
print(f"raised cosine (beta={beta}) eye:")
print(f"  mu0/mu1 = {eye.mu0:.3f}/{eye.mu1:.3f}  "
      f"s0/s1 = {eye.s0:.3f}/{eye.s1:.3f}")
print(f"  eye height = {eye.eye_h:.3f}, threshold = {eye.threshold:.3f}")

# zero-ISI sanity: mid-slot samples sit on the bit values
mid = v.signal.real[gv.sps // 2::gv.sps].cpu().numpy()
err = np.max(np.abs(np.round(mid) - tx.data[:mid.size]))
print(f"  max mid-slot deviation from bits: {err:.3f}")

if args.show:
    import matplotlib.pyplot as plt
    # the eye of the metrology above, titled (``plot_eye`` passes its
    # keywords to GET_EYE, which takes no title)
    eye.plot(title=f"Raised Cosine Pulse (beta={beta})")
    plt.ylim(-0.3, 1.3)
    plt.show()
