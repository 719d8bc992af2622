"""The benchmark entry of ``LinkProgram.dsp_wdm`` with the sweep's spans: the
channels of a WDM sweep, each chain one after another on one card
(:mod:`perfbench.entries.dsp_wdm`'s call).  Span recording is on from the
build: the first channel's answers carry the spans the call recorded
(``spans``: a ``sweep.channel`` span a channel, around that channel's
chain), which the ``sweep.*`` metrics read against the device trace, and
each channel's answers say whether the call's eye metrology replayed its
CUDA graph (``eye_graph``, from the program's ``eyeana.GRAPH_COUNTS``: no
sync)."""
from perfbench.entries import dsp_wdm
from perfbench.pbcore.ook import NAMES, readings, receiver_bytes  # noqa: F401


def build(link, spec, params, n_bits: int, traffic: dict, device):
    """``dsp_wdm``'s program, span recording on."""
    from opticomlib_tpu_torch.utils import profiling
    prog = dsp_wdm.build(link, spec, params, n_bits, traffic, device)
    profiling.record(True)
    profiling.drain()
    return prog


def call(prog, bits, seed: int, draws: list, traffic: dict) -> list:
    """``bits``: ``(channels, n_bits)``; ``draws``: one dict a channel.
    Returns the answers of each channel, the first with the call's
    spans."""
    from opticomlib_tpu_torch.ops import eyeana
    from opticomlib_tpu_torch.utils import profiling
    replayed = eyeana.GRAPH_COUNTS["replayed"]
    out = dsp_wdm.call(prog, bits, seed, draws, traffic)
    graph = eyeana.GRAPH_COUNTS["replayed"] > replayed
    out = [dict(ch, eye_graph=graph) for ch in out]
    out[0]["spans"] = profiling.drain()
    return out
