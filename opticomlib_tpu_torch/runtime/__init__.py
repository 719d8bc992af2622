"""Runtime services: checkpoint and resume of long propagations (port of
``opticomlib_tpu.runtime``; its backend routing and XLA compilation cache
have no counterpart in an eager PyTorch program and are not ported)."""
from .checkpoint import (
    PropagationCheckpointer, span_chain_resumable,
    ssfm_propagate_resumable,
)

__all__ = ["PropagationCheckpointer", "ssfm_propagate_resumable",
           "span_chain_resumable"]
