"""OOK 10 Gbps transmission over 50 km of fiber (BASELINE configs 1-2) on
PyTorch; twin of examples/ook_transmission_fiber_simulation.py (the
reference's canonical example): the full PRBS -> DAC -> LASER -> MZM ->
FIBER -> PD -> DSP -> BER chain through the port's staged devices, on the
card (the DAC's pulse shaping, the fiber's kicks and spectral products
and the receiver's histograms are the hand-written kernels).

Run:  python examples/torch/ook_transmission_fiber_simulation.py
      [--device cpu] [--show]
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

from opticomlib_tpu_torch import gv, theory_BER
from opticomlib_tpu_torch.devices import DAC, FIBER, LASER, MZM, PD, PRBS
from opticomlib_tpu_torch.models import ook

ap = argparse.ArgumentParser(description="OOK over 50 km of fiber")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--show", action="store_true", help="draw the eye")
args = ap.parse_args()

nm = 1e-9

# simulation parameters
gv(sps=64, R=10e9, wavelength=1550 * nm, Vpi=5, N=2**10,
   device=args.device).print()

# transmitter
tx_seq = PRBS(order=9, len=gv.N)
v = DAC(tx_seq, Vpp=gv.Vpi, offset=-gv.Vpi / 2, pulse_shape="gaussian")
cw_laser = LASER(P0=5)  # 5 dBm CW source
mod_signal = MZM(cw_laser, v, bias=-gv.Vpi / 2, Vpi=gv.Vpi, loss_dB=3,
                 ER_dB=26)

# channel: 50 km NLSE (dispersion + Kerr + attenuation)
fiber_signal = FIBER(mod_signal, length=50, alpha=0.2, beta_2=-20, gamma=2)
P_avg = float(fiber_signal.power("dBm"))

# receiver
pd_signal = PD(fiber_signal, BW=gv.R * 0.75, r=1, include_noise="all")
rx_seq, eye_, rth = ook.DSP(pd_signal)

# analysis
ber = ook.BER_analizer("counter", Tx=tx_seq, Rx=rx_seq)
ber_theory = theory_BER(P_avg=P_avg, modulation="ook", ER=26, amplify=False,
                        BW_el=0.75 * gv.R, r=1.0, T=300, R_L=50)

print(f"Average received power: {P_avg:.2f} dBm")
print(f"BER counts: {ber:.2e} ({ber * tx_seq.size:.0f} errors of "
      f"{tx_seq.size} transmitted bits)")
print(f"BER theoretical: {float(ber_theory):.2e}")
eye_.print("eye metrics")

if args.show:
    eye_.plot()
    eye_.show()
