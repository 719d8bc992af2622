"""The least time of the work the traced calls needed
(:mod:`perfbench.pbcore.work`, from the configuration's shapes, the step
counts the calls returned and the entry driver's ``receiver_bytes``) over
the device's busy time in the traced window, in %.  Held to the published
H100 SXM peaks; meaningful where the field does not fit in the 50 MB L2
(2^24 samples).  Over several cards each card's share is the calls' work
over the world's size (sharding adds no least work), over the busy time of
the card traced (rank 0's)."""
from perfbench.pbcore import work


def read(ctx):
    rx = getattr(ctx.entry, "receiver_bytes", None)
    if not ctx.busy_s or rx is None:
        return None
    rx_bytes = rx(ctx.cfg, ctx.traffic, ctx.n, ctx.n_bits)
    by = fl = 0.0
    for res in ctx.calls:
        for ch in res:
            b, f = work.channel_work(ctx.cfg, ctx.n, ctx.n_bits, rx_bytes,
                                     ch["n_steps"])
            by += b
            fl += f
    return 100.0 * work.least_time_s(by, fl) / ctx.world / ctx.busy_s
