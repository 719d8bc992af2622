"""Enters the CPU size of the M-PPM cell ``ppm8_20km.ppm_hard_2e24`` into
``perfbench/tests/conftest.py``'s ``SMALL`` before any test of
``perfbench/`` is collected, so that every test file finds it whichever
runs first or alone.  The size belongs in ``SMALL`` itself; this file goes
when it is moved there."""
from perfbench.tests.conftest import SMALL

SMALL.setdefault("ppm8_20km.ppm_hard_2e24", 2**16)
