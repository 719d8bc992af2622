"""Enters the CPU size of the staged cell ``ook_example_50km.staged_2e24``
into ``perfbench/tests/conftest.py``'s ``SMALL`` before any test is
collected, so that every test file of ``perfbench/`` finds it whichever
runs first or alone (as ``perfbench/conftest.py`` does for the M-PPM
cell).  The size belongs in ``SMALL`` itself; this file goes when it is
moved there."""
from perfbench.tests.conftest import SMALL

SMALL.setdefault("ook_example_50km.staged_2e24", 2**16)
