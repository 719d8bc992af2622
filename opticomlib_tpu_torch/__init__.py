"""opticomlib_tpu_torch — the optical-link simulator on PyTorch and CUDA.

A port of ``opticomlib_tpu`` (JAX) to PyTorch for NVIDIA Hopper cards, slice
by slice.  This package holds the fused OOK link (``link.build_link`` ->
``LinkProgram.dsp``): PRBS -> DAC -> laser (phase noise, RIN, offset) +
MZM/PM -> split-step fiber (reference, 4th-order and local-error schemes),
EDFA, DBP, DM and BPF stages, repeated spans -> photodiode -> Bessel LPF ->
ADC -> eye metrology -> threshold -> BER.  Its pointwise split-step passes,
its ADC and its receiver histogram are hand-written kernels
(:mod:`opticomlib_tpu_torch.ops.kernels`), built on first use on a CUDA
tensor; importing the package builds nothing and imports no JAX.
"""
from .link import (BPFSpec, DBPSpec, DMSpec, EDFASpec, FiberSpec,
                   LinkProgram, LinkSpec, RepeatSpec, build_link)
from .ops.prbs import prbs
from .params import SimParams

__all__ = ["BPFSpec", "DBPSpec", "DMSpec", "EDFASpec", "FiberSpec",
           "LinkProgram", "LinkSpec", "RepeatSpec", "SimParams",
           "build_link", "prbs"]
__version__ = "0.1.0"
