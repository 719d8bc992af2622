"""Faults planted under the timed path of a run over several ranks, for
the CPU tests (``test_perfbench_ranks.py``): a rank of ``run.py`` plants
the one that ``PERFBENCH_RANK_FAULT`` names, given its rank, before
anything else."""


def block_altered(rank: int) -> None:
    """Rank 3's block of its first channel shifted by one sample where the
    receiver produces it."""
    import torch
    from opticomlib_tpu_torch.link_sharded import ShardedLinkProgram
    receive = ShardedLinkProgram._receive

    def shifted(self, field, normal):
        v = receive(self, field, normal).clone()
        v[0] = torch.roll(v[0], 1)
        return v
    if rank == 3:
        ShardedLinkProgram._receive = shifted


def half_channels(rank: int) -> None:
    """The sweep answers for the first half of its channels only."""
    from opticomlib_tpu_torch.link_sharded import ShardedLinkProgram
    dsp_wdm = ShardedLinkProgram.dsp_wdm

    def half(self, n_channels, **kw):
        r = dsp_wdm(self, n_channels, **kw)
        h = n_channels // 2
        for k in ("n_errors", "threshold", "mu0", "mu1", "s0", "s1",
                  "rin_ok", "n_steps"):
            setattr(r, k, getattr(r, k)[:h])
        return r
    ShardedLinkProgram.dsp_wdm = half


def frozen_fiber(rank: int) -> None:
    """Every adaptive step returns its field unchanged (the step counts
    stay the loop's)."""
    from opticomlib_tpu_torch.link_sharded import ShardedLinkProgram
    adaptive = ShardedLinkProgram._adaptive

    def frozen(self, A, *args):
        return A, adaptive(self, A.clone(), *args)[1]
    ShardedLinkProgram._adaptive = frozen


def no_exchange(rank: int) -> None:
    """The pencil FFT's all-to-alls left out: each rank keeps its own."""
    from opticomlib_tpu_torch.parallel import dfft
    dfft._all_to_all = lambda z, axis: z.contiguous()


def errors_altered(rank: int) -> None:
    """The error count is one off where the receiver produces it."""
    from opticomlib_tpu_torch import link
    decide = link._ook_decide
    link._ook_decide = lambda *a: (lambda r, e: (r, e + 1))(*decide(*a))


def one_card(rank: int) -> None:
    """Not a fault of the program: the rank's look for the cards finds a
    CUDA card, and only one."""
    import torch
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 1


FAULTS = {f.__name__: f for f in (block_altered, half_channels,
                                  frozen_fiber, no_exchange,
                                  errors_altered, one_card)}
