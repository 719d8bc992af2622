"""opticomlib_tpu_torch — the optical-link simulator on PyTorch and CUDA.

A port of ``opticomlib_tpu`` (JAX) to PyTorch for NVIDIA Hopper cards, slice
by slice.  This package holds the fused OOK link (``link.build_link`` ->
``LinkProgram.dsp``): PRBS -> DAC -> MZM -> split-step fiber -> EDFA ->
photodiode -> Bessel LPF -> eye metrology -> threshold -> BER.  Its
pointwise split-step passes and its receiver histogram are hand-written
kernels (:mod:`opticomlib_tpu_torch.ops.kernels`), built on first use on a
CUDA tensor; importing the package builds nothing and imports no JAX.
"""
from .link import EDFASpec, FiberSpec, LinkProgram, LinkSpec, build_link
from .ops.prbs import prbs
from .params import SimParams

__all__ = ["EDFASpec", "FiberSpec", "LinkProgram", "LinkSpec", "SimParams",
           "build_link", "prbs"]
__version__ = "0.1.0"
