"""opticomlib_tpu_torch — the optical-link simulator on PyTorch and CUDA.

A port of ``opticomlib_tpu`` (JAX) to PyTorch for NVIDIA Hopper cards, slice
by slice.  It holds two surfaces:

* the fused link (``link.build_link`` -> ``LinkProgram.dsp``, ``eye``,
  ``dsp_ppm``, and the WDM sweeps ``dsp_wdm`` / ``dsp_wdm_ppm``): PRBS ->
  DAC -> laser (phase noise, RIN, offset) + MZM/PM -> split-step fiber
  (reference, 4th-order and local-error schemes), EDFA, DBP, DM and BPF
  stages, repeated spans -> photodiode -> Bessel LPF -> ADC -> eye
  metrology -> threshold -> BER;
* the staged drop-in API of the reference: ``gv``, the signal classes,
  ``devices`` (``PRBS`` ... ``SAMPLER``), ``ook`` and ``ppm`` (``DSP``,
  ``BER_analizer``), on ``gv``'s device (the card by default;
  ``gv(device="cpu")`` asks for the CPU).

Its pointwise split-step passes, the DAC's pulse shaping, its ADC and its
receiver histogram are hand-written kernels
(:mod:`opticomlib_tpu_torch.ops.kernels`), built on first use on a CUDA
tensor; importing the package builds nothing and imports no JAX.
"""
from . import devices, ook, ppm, rng
from .eyediag import Eye, eye
from .link import (BPFSpec, DBPSpec, DMSpec, EDFASpec, FiberSpec,
                   LinkProgram, LinkSpec, RepeatSpec, build_link)
from .ops.prbs import prbs
from .ops.pulses import (fft_convolve_same, gauss_pulse, nrz_pulse,
                         rcos_pulse, upfir)
from .params import GlobalVariables, SimParams, global_variables, gv
from .signals import (NULL, BinarySequence, ElectricalSignal, OpticalSignal,
                      binary_sequence, electrical_signal, optical_signal)
from .utils.theory import theory_BER

__all__ = ["BPFSpec", "DBPSpec", "DMSpec", "EDFASpec", "FiberSpec",
           "LinkProgram", "LinkSpec", "RepeatSpec", "SimParams",
           "build_link", "prbs", "devices", "ook", "ppm", "rng", "Eye", "eye",
           "fft_convolve_same", "gauss_pulse", "nrz_pulse", "rcos_pulse",
           "upfir", "GlobalVariables", "global_variables", "gv", "NULL",
           "BinarySequence", "ElectricalSignal", "OpticalSignal",
           "binary_sequence", "electrical_signal", "optical_signal",
           "theory_BER"]
__version__ = "0.1.0"
