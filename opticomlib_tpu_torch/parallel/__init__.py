"""Runs over several ranks (``torch.distributed``): the mesh, the sharded
split-step fiber with its pencil FFT and halo exchange, the span pipeline,
and the bring-up (port of ``opticomlib_tpu.parallel``)."""
from .fiber import make_link_mesh, shard_waveform, ssfm_sharded
from .multihost import initialize_multihost
from .pipeline import make_span_mesh, span_pipeline

__all__ = ["make_link_mesh", "shard_waveform", "ssfm_sharded",
           "initialize_multihost", "make_span_mesh", "span_pipeline"]
