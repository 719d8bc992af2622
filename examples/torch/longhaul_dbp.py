"""Coherent-style long-haul link on PyTorch: 20 x 80 km amplified spans
with digital back-propagation receiver equalization (BASELINE config 4);
twin of examples/longhaul_dbp.py.

Each span is FIBER + EDFA (gain = span loss); the receiver runs DBP with
the signs inverted over the full 1600 km.  The field stays on the card
from the modulator to the EVM: every split step is the port's kick and
spectral-product kernels.

Run:  python examples/torch/longhaul_dbp.py [--device cpu]
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

from opticomlib_tpu_torch import gv
from opticomlib_tpu_torch.devices import DAC, DBP, EDFA, FIBER, LASER, MZM, PRBS
from opticomlib_tpu_torch.signals import OpticalSignal

ap = argparse.ArgumentParser(description="20 x 80 km with DBP")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

gv(sps=32, R=10e9, wavelength=1550e-9, N=2**10, device=args.device).print()
np.random.seed(1)

N_SPANS = 20
SPAN_KM = 80.0
ALPHA, BETA2, GAMMA = 0.2, -21.0, 1.3
SPAN_LOSS_DB = ALPHA * SPAN_KM

tx = PRBS(order=11, len=gv.N)
v = DAC(tx, Vpp=5, offset=-2.5, pulse_shape="rcos", beta=0.3)
laser = LASER(P0=10)
sig = MZM(laser, v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=30)

# The accumulated dispersion over 1600 km is enormous (~34,000 ps^2), so
# the forward/backward split-step asymmetry is the accuracy limiter: use a
# fixed step so DBP walks the same schedule as the line (EVM converges
# ~O(h^2): 0.18 @ h=1 km -> 0.047 @ h=0.25 km on this configuration).
H_STEP = 0.25

# ---- transmission line: 20 x (80 km fiber + EDFA) ----
x = sig
for span in range(N_SPANS):
    x = FIBER(x, length=SPAN_KM, alpha=ALPHA, beta_2=BETA2, gamma=GAMMA,
              h=H_STEP)
    x = EDFA(x, G=SPAN_LOSS_DB, NF=5)
P_out = float(np.sum(np.atleast_1d(x.power("W"))))
print(f"after {N_SPANS} spans: P = {10*np.log10(P_out*1e3):.2f} dBm")

# ---- receiver: ideal coherent detection + DBP over the full line ----
# DBP inverts the deterministic propagation; ASE stays (collapse noise
# into the field for equalization, as a coherent receiver would see it)
field = OpticalSignal(x.signal[0] + x.noise[0])
eq = field
for span in range(N_SPANS):
    # undo the span in reverse order: EDFA gain first, then the fiber
    # (DBP = FIBER with all signs negated, so pass the span's own params)
    eq = OpticalSignal(eq.signal * 10 ** (-SPAN_LOSS_DB / 20))
    eq = DBP(eq, length=SPAN_KM, alpha=ALPHA, beta_2=BETA2, gamma=GAMMA,
             h=H_STEP)

# compare equalized waveform with the launched one
launched = sig.signal if sig.n_pol == 1 else sig.signal[0]
recovered = eq.signal
evm = float(torch.linalg.vector_norm(recovered - launched)
            / torch.linalg.vector_norm(launched))
print(f"post-DBP EVM vs launched field: {evm:.3f}")
