"""Runs over several ranks (``torch.distributed``): the mesh, the sharded
split-step fiber with its pencil FFT and halo exchange, and the bring-up
(port of ``opticomlib_tpu.parallel``; the span pipeline is not ported
yet)."""
from .fiber import make_link_mesh, shard_waveform, ssfm_sharded
from .multihost import initialize_multihost

__all__ = ["make_link_mesh", "shard_waveform", "ssfm_sharded",
           "initialize_multihost"]
