"""Modulation models of the staged API (port of ``opticomlib_tpu.models``)."""
