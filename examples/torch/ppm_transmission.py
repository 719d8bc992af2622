"""M=8 PPM transmission with matched optical filtering, hard- and
soft-decision decoding (BASELINE config 3) on PyTorch; twin of
examples/ppm_transmission.py.  Unseeded noise is legacy ``np.random`` on
the host in the JAX devices' order, so ``np.random.seed(0)`` gives both
packages the same draws.

Run:  python examples/torch/ppm_transmission.py [--device cpu]
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
from opticomlib_tpu_torch.devices import DAC, LASER, MZM, PD, PRBS
from opticomlib_tpu_torch.models import ppm

ap = argparse.ArgumentParser(description="8-PPM transmission")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

gv(sps=32, R=10e9, wavelength=1550e-9, N=2**10, device=args.device).print()
np.random.seed(0)

M = 8  # slots per symbol (3 bits/symbol)
k = int(np.log2(M))

# gv.N is the total SLOT count of the frame: N/M symbols -> k*N/M bits
tx_bits = PRBS(order=9, len=(gv.N // M) * k)
ppm_slots = ppm.PPM_ENCODER(tx_bits, M)

v = DAC(ppm_slots, Vpp=5, offset=-2.5, pulse_shape="gaussian")
laser = LASER(P0=8)
mod = MZM(laser, v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=26,
          BW=1.5 * gv.R)  # matched optical band-pass
pd_out = PD(mod, BW=0.75 * gv.R, include_noise="all")

for decision in ("hard", "soft"):
    rx_bits = ppm.DSP(pd_out, M, decision=decision)
    ber = ppm.BER_analizer("counter", Tx=tx_bits, Rx=rx_bits)
    print(f"{decision}-decision BER: {ber:.2e} "
          f"({ber * tx_bits.size:.0f} errors / {tx_bits.size} bits)")
