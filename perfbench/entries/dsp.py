"""Entry driver of ``LinkProgram.dsp``: one waveform a call, the chain and
the OOK receiver on the card, only scalars read back."""
from perfbench.pbcore.ook import NAMES, readings, receiver_bytes  # noqa: F401
from perfbench.pbcore.ook import answer


def build(link, spec, params, n_bits: int, traffic: dict, device):
    return link.build_link(spec, n_bits=n_bits, params=params, device=device)


def call(prog, bits, seed: int, draws: list, traffic: dict) -> list:
    """``bits``: ``(1, n_bits)``; ``draws``: one channel's dict.  Returns
    the channel's answers."""
    r = prog.dsp(bits=bits[0], seed=seed, nslots=traffic["nslots"],
                 sps_resamp=traffic["sps_resamp"], noise=draws[0])
    e = r.eye
    return [answer(r.n_errors, r.threshold, e.mu0, e.mu1, e.s0, e.s1,
                   r.n_steps, r.rin_ok)]
