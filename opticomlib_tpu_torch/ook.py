"""OOK modulation stack (alias of
:mod:`opticomlib_tpu_torch.models.ook`)."""
from .models.ook import *  # noqa: F401,F403
from .models.ook import __all__  # noqa: F401
# the reference's ook module also exposes the devices it uses
# (reference ook.py:16: ``from .devices import GET_EYE, SAMPLER, LPF``)
from .devices import GET_EYE, LPF, SAMPLER  # noqa: F401
# ... and the typing/utils names it imports into its namespace
# (reference ook.py:16-18: gv, binary_sequence, electrical_signal, eye, Q, tic, toc)
from .params import gv  # noqa: F401
from .signals import binary_sequence, electrical_signal  # noqa: F401
from .eyediag import eye  # noqa: F401
from .utils.analysis import tic, toc  # noqa: F401
from .utils.theory import Q  # noqa: F401

# star-import drop-in parity: the reference ook module has no __all__, so
# ``from opticomlib.ook import *`` exports the names above too
__all__ = list(__all__) + [  # noqa: F405
    "GET_EYE", "LPF", "SAMPLER", "gv", "binary_sequence",
    "electrical_signal", "eye", "tic", "toc", "Q",
]
