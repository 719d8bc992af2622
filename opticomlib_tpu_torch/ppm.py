"""PPM modulation stack (alias of :mod:`opticomlib_tpu_torch.models.ppm`)."""
from .models.ppm import *  # noqa: F401,F403
from .models.ppm import __all__  # noqa: F401
# the reference's ppm module also exposes the devices it uses
# (reference ppm.py:21: ``from .devices import GET_EYE, SAMPLER, LPF``)
from .devices import GET_EYE, LPF, SAMPLER  # noqa: F401
# ... and the typing/utils names it imports into its namespace
# (reference ppm.py:21-23: gv, binary_sequence, electrical_signal, eye,
#  Q, dec2bin, str2array, tic, toc)
from .params import gv  # noqa: F401
from .signals import Array_Like, binary_sequence, electrical_signal  # noqa: F401
from .eyediag import eye  # noqa: F401
from .utils.analysis import dec2bin, str2array, tic, toc  # noqa: F401
from .utils.theory import Q  # noqa: F401

# star-import drop-in parity: the reference ppm module has no __all__, so
# ``from opticomlib.ppm import *`` exports the names above too
__all__ = list(__all__) + [  # noqa: F405
    "GET_EYE", "LPF", "SAMPLER", "gv", "Array_Like", "binary_sequence",
    "electrical_signal", "eye", "dec2bin", "str2array", "tic", "toc", "Q",
]
