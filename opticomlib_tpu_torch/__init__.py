"""opticomlib_tpu_torch — the optical-link simulator on PyTorch and CUDA.

A port of ``opticomlib_tpu`` (JAX) to PyTorch for NVIDIA Hopper cards, slice
by slice.  It holds two surfaces, and the runtimes around the fiber:

* the fused link (``link.build_link`` -> ``LinkProgram.dsp``, ``eye``,
  ``dsp_ppm``, and the WDM sweeps ``dsp_wdm`` / ``dsp_wdm_ppm``; with
  ``mesh=`` the ``ShardedLinkProgram`` over ``torch.distributed`` ranks):
  PRBS -> DAC -> laser (phase noise, RIN, offset) + MZM/PM -> split-step fiber
  (reference, 4th-order and local-error schemes), EDFA, DBP, DM and BPF
  stages, repeated spans -> photodiode -> Bessel LPF -> ADC -> eye
  metrology -> threshold -> BER;
* the staged drop-in API of the reference: ``gv``, the signal classes
  (with their NumPy protocol and drawing), ``devices`` (``PRBS`` ...
  ``SAMPLER``, ``FBG``, the fiber animations), ``ook`` and ``ppm``
  (``DSP``, ``BER_analizer``), the eye drawing, ``lab`` and the utility
  layer, on ``gv``'s device (the card by default; ``gv(device="cpu")``
  asks for the CPU);
* :mod:`~opticomlib_tpu_torch.runtime` (checkpoint and resume of long
  propagations), :mod:`~opticomlib_tpu_torch.parallel` (the split-step
  fiber sharded over ``torch.distributed`` ranks, ``FIBER(mesh=...)``) and
  :mod:`~opticomlib_tpu_torch.utils.profiling`.

Its pointwise split-step passes, the DAC's pulse shaping, its ADC, its
receiver histogram and the Bragg grating's coupled-mode integration are
hand-written kernels
(:mod:`opticomlib_tpu_torch.ops.kernels`), built on first use on a CUDA
tensor; importing the package builds nothing and imports no JAX, and
Matplotlib and tqdm only when a drawing or a progress bar is asked for.
"""
import torch

# torch's CPU sqrt, exp, log, sin... call MKL's vector math, which sets
# itself up on its first call.  When that first call is a tensor split over
# several intra-op threads, the threads set it up at once, and about one
# first call in thirty under load computes one thread's share on a
# low-accuracy path (errors to 3e-4 relative, for that call only).  One
# small call on this thread first takes the set-up out of any parallel call.
torch.sqrt(torch.ones(16))

from logging import DEBUG, INFO, WARNING  # noqa: E402

import numpy as np  # noqa: E402
from numpy import ndarray  # noqa: E402
from numpy.fft import fft, ifft, fftfreq, fftshift, ifftshift  # noqa: E402
from scipy.constants import c, e, h, k as kB, pi  # noqa: E402

from .params import SimParams, GlobalVariables, global_variables, gv  # noqa: E402
from .signals import (  # noqa: E402
    NULL, NULLType, Array_Like, RealNumber, ComplexNumber,
    BinarySequence, ElectricalSignal, OpticalSignal,
    binary_sequence, electrical_signal, optical_signal,
)
from .eyediag import Eye, eye, EyeShowOptions, eyediagram  # noqa: E402
from .logger import HierLogger, hlog  # noqa: E402
from .utils.analysis import (  # noqa: E402
    db, dbm, idb, idbm, gaus, Q, phase, tau_g, dispersion, rcos, si, norm,
    nearest, nearest_index, shortest_int, dec2bin, str2array, tic, toc,
    get_time, bode, get_psd, phase_estimator,
    apply_optimized_gaussian_filter,
)
from .utils.theory import (  # noqa: E402
    p_ase, average_voltages, noise_variances, optimum_threshold, theory_BER,
)
from .ops.pulses import (  # noqa: E402
    nrz_pulse, gauss_pulse, rcos_pulse, upfir, fft_convolve_same,
    resample_fft,
)

from . import devices  # noqa: E402
from . import lab      # noqa: E402
from . import link     # noqa: E402
from . import ook      # noqa: E402
from . import ppm      # noqa: E402
from . import rng      # noqa: E402
# the fused link's names, importable from the package (outside __all__,
# which is the JAX package's)
from .link import (BPFSpec, DBPSpec, DMSpec, EDFASpec, FiberSpec,  # noqa: E402,F401
                   LinkProgram, LinkSpec, RepeatSpec, build_link)
from .link_sharded import ShardedLinkProgram  # noqa: E402,F401
from .ops.prbs import prbs  # noqa: E402,F401

__version__ = "0.1.0"

# the JAX package's __all__ but its compilation cache (enable_cache,
# cache_dir), which has no counterpart here
__all__ = [
    "SimParams", "GlobalVariables", "global_variables", "gv",
    "NULL", "NULLType", "Array_Like", "RealNumber", "ComplexNumber",
    "BinarySequence", "ElectricalSignal", "OpticalSignal",
    "binary_sequence", "electrical_signal", "optical_signal",
    "Eye", "eye", "EyeShowOptions", "eyediagram",
    "db", "dbm", "idb", "idbm", "gaus", "Q", "phase", "tau_g", "dispersion",
    "rcos", "si", "norm", "nearest", "nearest_index", "shortest_int",
    "dec2bin", "str2array", "tic", "toc", "get_time", "bode", "get_psd",
    "phase_estimator", "apply_optimized_gaussian_filter",
    "HierLogger", "hlog",
    "p_ase", "average_voltages", "noise_variances", "optimum_threshold",
    "theory_BER",
    "nrz_pulse", "gauss_pulse", "rcos_pulse", "upfir", "fft_convolve_same",
    "resample_fft",
    "devices", "lab", "link", "ook", "ppm", "rng", "np", "ndarray",
    # reference-script drop-in convenience re-exports (reference
    # opticomlib/__init__.py; docstring examples use
    # `from opticomlib import gv, np, plt` and `gv(verbose=DEBUG)`)
    "DEBUG", "INFO", "WARNING",
    "c", "e", "h", "kB", "pi",
    "fft", "ifft", "fftfreq", "fftshift", "ifftshift",
    "sizeof",
]


def sizeof(obj) -> int:
    """Deep in-memory size of an object in bytes (reference parity: `from
    pympler.asizeof import asizeof as sizeof`, reference
    opticomlib/typing.py:13).  Uses pympler when available, otherwise a
    recursive ``sys.getsizeof`` walk that also counts ndarray buffers and
    tensor storage."""
    try:
        from pympler.asizeof import asizeof
        return int(asizeof(obj))
    except (ImportError, TypeError):
        pass
    import sys as _sys
    seen = set()

    def _walk(o):
        if id(o) in seen:
            return 0
        seen.add(id(o))
        size = _sys.getsizeof(o, 0)
        if isinstance(o, np.ndarray):
            size += o.nbytes
        elif isinstance(o, torch.Tensor):
            size += o.numel() * o.element_size()
        elif isinstance(o, dict):
            size += sum(_walk(k) + _walk(v) for k, v in o.items())
        elif isinstance(o, (list, tuple, set, frozenset)):
            size += sum(_walk(i) for i in o)
        elif hasattr(o, "__dict__"):
            size += _walk(vars(o))
        return size

    return _walk(obj)


# matplotlib is exported lazily for reference-script parity
# (`from opticomlib import plt`); importing it eagerly would slow down
# headless compute jobs.
def __getattr__(name):
    if name == "plt":
        import matplotlib.pyplot as plt
        return plt
    raise AttributeError(
        f"module 'opticomlib_tpu_torch' has no attribute {name!r}")
