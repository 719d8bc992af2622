"""Plain reference of ``ook_50km_wdm16`` (BASELINE config 5): each channel
of the sweep is one run of config 2's link on that channel's bits and
draws, so a channel's reference is ``ook_50km``'s, from
:mod:`perfbench.reference.plainlink`."""
from perfbench.reference.plainlink import run  # noqa: F401
