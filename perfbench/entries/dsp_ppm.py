"""Entry driver of ``LinkProgram.dsp_ppm``: one waveform of M-PPM symbols a
call, the chain and the hard receiver on the card (eye, threshold, slicer,
HDD repair, decoder), only scalars read back.  The HDD scores are drawn on
the card in the call's time from the call's information bits
(:mod:`perfbench.pbcore.ppm`); each answer says whether the call's eye
metrology replayed its CUDA graph (``eye_graph``, from the program's host
counters: no sync)."""
from perfbench.pbcore import ppm
from perfbench.pbcore.ppm import NAMES, readings, receiver_bytes  # noqa: F401


def build(link, spec, params, n_bits: int, traffic: dict, device):
    return link.build_link(spec, n_bits=n_bits, params=params, device=device)


def call(prog, bits, seed: int, draws: list, traffic: dict) -> list:
    """``bits``: ``(1, n_bits)``, one bit a slot, of which the call carries
    the first ``n_sym * log2(M)`` as information bits; ``draws``: one
    channel's dict.  Returns the channel's answers."""
    from opticomlib_tpu_torch.ops import eyeana
    M = int(traffic["M"])
    info = ppm.info_bits(bits[0], M)
    noise = dict(draws[0], hdd=ppm.hdd_scores(info, M, prog.device))
    replayed = eyeana.GRAPH_COUNTS["replayed"]
    r = prog.dsp_ppm(M, decision=traffic["decision"], bits=info, seed=seed,
                     nslots=traffic["nslots"],
                     sps_resamp=traffic["sps_resamp"], noise=noise)
    return [ppm.answer(r, eyeana.GRAPH_COUNTS["replayed"] > replayed)]
