"""Entry driver of ``LinkProgram.dsp_wdm``: the channels of a WDM sweep,
each chain one after another on the card (channel ``c`` on ``seed + c``),
the receivers batched, the per-channel results read back once."""
from perfbench.pbcore.ook import NAMES, readings, receiver_bytes  # noqa: F401
from perfbench.pbcore.ook import answer


def build(link, spec, params, n_bits: int, traffic: dict, device):
    return link.build_link(spec, n_bits=n_bits, params=params, device=device)


def call(prog, bits, seed: int, draws: list, traffic: dict) -> list:
    """``bits``: ``(channels, n_bits)``; ``draws``: one dict a channel.
    Returns the answers of each channel the sweep answered for."""
    r = prog.dsp_wdm(len(bits), bits=bits, seed=seed,
                     nslots=traffic["nslots"],
                     sps_resamp=traffic["sps_resamp"], noise=draws)
    return [answer(r.n_errors[c], r.threshold[c], r.mu0[c], r.mu1[c],
                   r.s0[c], r.s1[c], r.n_steps[c], r.rin_ok[c])
            for c in range(len(r.n_errors))]
