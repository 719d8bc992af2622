"""Fused end-to-end OOK link on PyTorch: the whole TX -> channel -> RX
chain as one program of the port (its kicks, spectral products and
receiver histograms are the hand-written kernels on the card); twin of
examples/fused_link.py, whose physics, sizes and printed lines it keeps.

Run: python examples/torch/fused_link.py [--device cpu]
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
from opticomlib_tpu_torch.link import EDFASpec, FiberSpec, LinkSpec, build_link

ap = argparse.ArgumentParser(description="fused OOK link")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

gv(sps=32, R=10e9, wavelength=1550e-9, N=2**14, device=args.device)

spec = LinkSpec(
    # TX: gaussian pulse shaping, MZM at quadrature
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5,
    P0=5, lw=100e3, rin=-150,          # laser: 100 kHz linewidth, RIN
    loss_dB=3, ER_dB=26,
    # channel: 50 km NLSE fiber + EDFA with physical ASE
    stages=(FiberSpec(length=50, alpha=0.2, beta_2=-21.0, gamma=1.3),
            EDFASpec(G=10, NF=5)),
    # RX: PIN PD with thermal+shot noise, 7.5 GHz Bessel LPF
    pd_BW=7.5e9,
)

prog = build_link(spec, n_bits=gv.N)      # on gv's device
res = prog.run(seed=42)                   # PRBS -> ... -> RX, reproducible

print(f"n = {prog.n} samples in one program")
print(f"BER (eye-threshold decision): {res.ber():.2e}")

# the output is a normal ElectricalSignal: the staged DSP just works
from opticomlib_tpu_torch import ook  # noqa: E402

rx, eye_obj, rth = ook.DSP(res.v)
print(f"ook.DSP threshold = {rth:.3f},  ER = {eye_obj.er:.1f} dB")
print("BER via ook stack:",
      ook.BER_analizer("counter", Tx=res.tx, Rx=rx))

# same seed -> bit-identical waveform
res2 = prog.run(seed=42)
assert np.array_equal(res.v.to_numpy(), res2.v.to_numpy())
print("reproducibility: OK")
