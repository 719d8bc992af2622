"""Entry driver of ``ShardedLinkProgram.dsp_wdm`` (``build_link(mesh=)``):
the channels of a WDM sweep over the mesh's 'wdm' axis and each waveform
over its 'time' axis, one rank a card; every rank makes the same call with
the whole bits (SPMD) and the draws of its own channels, and answers for
every channel (the per-channel scalars are gathered).  The timed path's
voltage is this rank's block of it (:func:`capture`, :func:`block`)."""
from perfbench.entries import dsp_wdm
from perfbench.pbcore.ook import NAMES, readings, receiver_bytes  # noqa: F401


def build(link, spec, params, n_bits: int, traffic: dict, device):
    from opticomlib_tpu_torch.parallel import make_link_mesh
    mesh = make_link_mesh(n_wdm=int(traffic["mesh"]["wdm"]),
                          n_time=int(traffic["mesh"]["time"]))
    if mesh.device != device:
        raise ValueError(f"the mesh computes on {mesh.device}, the run on "
                         f"{device}")
    return link.build_link(spec, n_bits=n_bits, params=params, mesh=mesh)


def call(prog, bits, seed: int, draws: list, traffic: dict) -> list:
    """``dsp_wdm``'s call (``draws``: ``None`` for another rank's channel);
    each channel's answers also say whether the call's eye metrology
    replayed its CUDA graph (``eye_graph``, from the program's host
    counters: no sync)."""
    from opticomlib_tpu_torch.ops import eyeana
    replayed = eyeana.GRAPH_COUNTS["replayed"]
    out = dsp_wdm.call(prog, bits, seed, draws, traffic)
    graph = eyeana.GRAPH_COUNTS["replayed"] > replayed
    return [dict(ch, eye_graph=graph) for ch in out]


def block(prog, channels: int) -> tuple:
    """Where this rank's block of the ``(channels, n)`` voltage lies:
    ``(first channel, end, first sample, end)``."""
    lc = channels // prog.n_wdm
    c0 = prog.mesh.index(prog.wdm_axis) * lc
    t0 = prog.mesh.index(prog.time_axis) * prog.block
    return c0, c0 + lc, t0, t0 + prog.block


def channels(prog, channels: int) -> range:
    """The channels whose draws this rank takes."""
    c0, c1, _, _ = block(prog, channels)
    return range(c0, c1)


class _Capture:
    def __init__(self, prog, hook):
        self.prog = prog
        core = type(prog)._core

        def timed(*args, **kw):
            out = core(prog, *args, **kw)
            hook(prog, args, out)
            return out
        prog._core = timed   # an attribute of this program alone

    def remove(self):
        del self.prog._core


def capture(prog, hook):
    """Call ``hook(prog, inputs, out)`` after the chain of each call on this
    rank (``out[0]``: its ``(channels of the rank, block)`` voltage, after
    the LPF); returns a handle with ``remove()``.  The sharded sweep runs
    its chain without the module's ``forward``, so no forward hook sees
    it."""
    return _Capture(prog, hook)
