"""The share of the traced device busy time in which a collective of NCCL
ran (a kernel named ``nccl...``: the pencil FFT's all-to-alls, the
adaptive loop's all-reduce a step, the gathers), in %, on rank 0's card.
An NCCL kernel runs from its start until its peers have joined and the
data has moved, so the share counts the wait for the slowest rank (the
imbalance) with the communication."""
from perfbench.pbcore.trace import union_s


def read(ctx):
    if not ctx.busy_s:
        return None
    nccl = [(s, t) for s, t, name in ctx.events if name.startswith("nccl")]
    if not nccl:
        return None
    return 100.0 * union_s(nccl) / ctx.busy_s
