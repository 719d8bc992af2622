"""Enters the CPU sizes of the staged cell ``ook_example_50km.staged_2e24``
and of the one-card sweep ``ook_50km.wdm16_2e26`` into
``perfbench/tests/conftest.py``'s ``SMALL`` before any test is collected,
so that every test file of ``perfbench/`` finds them whichever runs first
or alone (as ``perfbench/conftest.py`` does for the M-PPM cell).  The
sizes belong in ``SMALL`` itself; this file goes when they are moved
there."""
from perfbench.tests.conftest import SMALL

SMALL.setdefault("ook_example_50km.staged_2e24", 2**16)
SMALL.setdefault("ook_50km.wdm16_2e26", 2**14)
