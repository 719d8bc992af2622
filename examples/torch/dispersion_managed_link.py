"""Dispersion-managed fused link on PyTorch: N spans of [FIBER -> DM ->
EDFA] built once from ``RepeatSpec`` and run as one program of the port,
checked sample for sample against the staged device chain; twin of
examples/dispersion_managed_link.py.

Run: python examples/torch/dispersion_managed_link.py [--device cpu]
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
from opticomlib_tpu_torch.link import (DMSpec, EDFASpec, FiberSpec, LinkSpec,
                                       RepeatSpec, build_link)

ap = argparse.ArgumentParser(description="dispersion-managed fused link")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

gv(sps=16, R=10e9, wavelength=1550e-9, N=2**12, device=args.device)

N_SPANS, L, ALPHA, B2, GAMMA = 8, 80.0, 0.2, -21.0, 1.3

span = (
    FiberSpec(length=L, alpha=ALPHA, beta_2=B2, gamma=GAMMA, h=1.0),
    DMSpec(D=-B2 * L),                  # in-line dispersion compensation
    EDFASpec(G=ALPHA * L, NF=5),        # transparent gain + ASE
)

spec = LinkSpec(
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5,
    P0=5, loss_dB=3, ER_dB=26,
    stages=(RepeatSpec(N_SPANS, span),),
    pd_BW=7.5e9,
)

prog = build_link(spec, n_bits=gv.N)
res = prog.dsp(seed=11)                # fully fused RX: eye+threshold+BER
print(f"{N_SPANS} x {L:.0f} km dispersion-managed link, one program")
print(f"BER = {res.ber:.2e}   threshold = {res.threshold:.4f}")
print(res.eye)

# --- noiseless cross-check: fused RepeatSpec == staged device chain ---
from opticomlib_tpu_torch.devices import DM, FIBER  # noqa: E402
from opticomlib_tpu_torch.ops.prbs import prbs  # noqa: E402
from opticomlib_tpu_torch.signals import OpticalSignal  # noqa: E402

spec_nl = LinkSpec(
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
    loss_dB=3, ER_dB=26,
    stages=(RepeatSpec(N_SPANS, (
        FiberSpec(length=L, alpha=ALPHA, beta_2=B2, gamma=GAMMA, h=1.0),
        DMSpec(D=-B2 * L), EDFASpec(G=ALPHA * L))),),  # NF=None: no ASE
    pd_BW=7.5e9, include_thermal=False, include_shot=False)
prog_nl = build_link(spec_nl, n_bits=gv.N, return_field=True)
bits, _ = prbs(9, length=gv.N)
bits_f32 = torch.as_tensor(bits.astype(np.float32), device=prog_nl.device)
fused_field = prog_nl.jitted(bits_f32, 0)[3]

# staged chain on the fused TX field (a back-to-back program gives the TX)
spec_tx = LinkSpec(pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5,
                   Vpi=5, P0=5, loss_dB=3, ER_dB=26, pd_BW=7.5e9,
                   include_thermal=False, include_shot=False)
prog_tx = build_link(spec_tx, n_bits=gv.N, return_field=True)
f = OpticalSignal(prog_tx.jitted(bits_f32, 0)[3])
for _ in range(N_SPANS):
    f = FIBER(f, length=L, alpha=ALPHA, beta_2=B2, gamma=GAMMA, h=1.0)
    f = DM(f, D=-B2 * L)
    f = OpticalSignal(f.signal * 10 ** (ALPHA * L / 20), n_pol=f.n_pol)
staged_field = f.signal.reshape(-1)

err = float((fused_field.reshape(-1) - staged_field).abs().max()
            / staged_field.abs().max())
print(f"fused RepeatSpec vs staged chain: max rel err = {err:.2e}")
# 8 x 80 km at h=1 km is 1280 float32 FFTs; the fused chain and the staged
# calls round differently (the JAX package sees ~1e-5 on its CPU backend)
assert err < 5e-3
