"""Plain reference of ``ook_50km`` (BASELINE config 2): the gaussian-pulse
MZM transmitter, one 50 km span of the phi_max-adaptive split-step (the
nonlinearity frozen at each step's start), a noisy EDFA, the PIN with
thermal and shot noise, the Bessel LPF and the OOK receiver, all from
:mod:`perfbench.reference.plainlink`."""
from perfbench.reference.plainlink import run  # noqa: F401
