"""Plain reference of ``longhaul_dbp`` (BASELINE config 4): the noisy laser
(Wiener phase, RIN) and MZM, 20 x (80 km of the fixed-step 4th-order
Yoshida split-step + a noisy EDFA) on two polarisations, 20 spans of
back-propagation (gain undone, every operator's sign flipped), the PIN,
the Bessel LPF, the 8-bit ADC over the shortest 99.99 % interval and the
OOK receiver, all from :mod:`perfbench.reference.plainlink`."""
from perfbench.reference.plainlink import run  # noqa: F401
