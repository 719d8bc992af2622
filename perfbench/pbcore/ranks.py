"""A run over several ranks: one process a card, for a cell whose
``chips`` is over 1.

The parent (``run.py`` as it is started) imports no ``torch``: it picks a
free port on 127.0.0.1 and starts ``chips`` ranks at once (:func:`launch`),
each ``run.py`` again with the hidden argument ``--rank`` and the variables
that ``torchrun`` sets (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``).  Each rank looks for the cards itself
(exit 2 if too few), then runs the same calls with the same whole inputs
(SPMD) on ``cuda:<LOCAL_RANK>``: the program's collectives over NCCL
(:func:`opticomlib_tpu_torch.parallel.multihost.initialize_multihost`,
called as under ``torchrun``), and the harness's own messages over a gloo
group of its own on the host (:class:`Team`), so that none of them runs on
the cards.  The parent prints rank 0's result and nothing else on standard
output.

``torchrun`` is not the launcher because its agent imports ``torch``
before it starts a rank, and that import is several seconds of
``setup_s`` in which no rank has started.

If a rank fails or is killed, the parent ends the others (``SIGTERM``,
then ``SIGKILL`` after :data:`GRACE_S`) and exits non-zero without a
result, within :data:`END_LIMIT_S` of the failure; a rank also dies with
its parent (``PR_SET_PDEATHSIG``), so none is left behind.
"""
from __future__ import annotations

import ctypes
import datetime
import os
import signal
import socket
import subprocess
import time

#: how often the parent looks at its ranks
POLL_S = 0.1
#: from ``SIGTERM`` to ``SIGKILL`` of a rank that is still up
GRACE_S = 5.0
#: the parent has ended every rank and exited this long after the first
#: rank failed, at the latest
END_LIMIT_S = 10.0
#: time limit of the program's collectives (NCCL, or gloo on the CPU)
COLLECTIVE_TIMEOUT_S = 300.0
#: time limit of the harness's own messages: the other ranks wait at a
#: barrier while rank 0 builds the kernels (a first run compiles)
CONTROL_TIMEOUT_S = 1200.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child, before ``exec``: ``SIGKILL`` when the parent dies
    (``prctl(PR_SET_PDEATHSIG)``)."""
    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))


def _wait(procs, log) -> int:
    """0 once every rank has ended with 0; else the code of the first rank
    that ended otherwise (1 for one ended by a signal), at once."""
    while True:
        rcs = [p.poll() for p in procs]
        for r, rc in enumerate(rcs):
            if rc not in (None, 0):
                log(f"[perfbench] rank {r} ended with {rc}: ending the "
                    f"others")
                return rc if rc > 0 else 1
        if all(rc == 0 for rc in rcs):
            return 0
        time.sleep(POLL_S)


def _end(procs) -> None:
    """End every rank still up, and reap them all."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + GRACE_S
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
    for p in procs:
        p.wait()


def launch(cmd: list, world: int, log) -> int:
    """Run ``world`` ranks of ``cmd`` and wait for them: 0 once every rank
    has ended with 0, else the code of the first rank that did not (2: a
    rank refused the run), with every rank ended."""
    procs = []
    stop = signal.getsignal(signal.SIGTERM)

    def ended(signum, _frame):
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, ended)
    try:
        env = dict(os.environ, WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        for r in range(world):
            procs.append(subprocess.Popen(
                cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdin=subprocess.DEVNULL, stdout=2,
                preexec_fn=_die_with_parent))
        return _wait(procs, log)
    finally:
        _end(procs)
        signal.signal(signal.SIGTERM, stop)


class Team:
    """This rank's view of the run: its rank, the world's size, its device,
    and the harness's messages between the ranks over a gloo group of their
    own (host tensors).  Joining brings up ``torch.distributed`` for the
    program too: NCCL on ``cuda:<LOCAL_RANK>``, gloo with
    ``device="cpu"``."""

    def __init__(self, device=None):
        import torch.distributed as dist
        from opticomlib_tpu_torch.parallel.multihost import \
            initialize_multihost
        self.rank = int(os.environ["RANK"])
        self.world = int(os.environ["WORLD_SIZE"])
        self.device = device or f"cuda:{int(os.environ['LOCAL_RANK'])}"
        initialize_multihost(device=self.device,
                             timeout_s=COLLECTIVE_TIMEOUT_S)
        self._dist = dist
        self._group = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))

    def barrier(self) -> None:
        self._dist.barrier(group=self._group)

    def agree(self, *flags) -> list:
        """Rank 0's ``flags`` on every rank."""
        import torch
        t = torch.tensor([int(f) for f in flags], dtype=torch.int64)
        self._dist.broadcast(t, 0, group=self._group)
        return [bool(f) for f in t.tolist()]

    def reduce(self, x: float, op: str) -> float:
        """``x`` reduced over the ranks: ``"max"`` or ``"mean"``."""
        import torch
        t = torch.tensor([float(x)], dtype=torch.float64)
        self._dist.all_reduce(t, self._dist.ReduceOp.MAX if op == "max"
                              else self._dist.ReduceOp.SUM,
                              group=self._group)
        return float(t[0]) / (self.world if op == "mean" else 1)

    def assemble(self, block, where: tuple, shape: tuple):
        """Every rank's ``block`` of a ``shape`` array, ``where`` it lies
        (``(row0, row1, col0, col1)``), put together on rank 0 (a host
        float32 tensor; NaN where no rank's block lies); ``None`` on the
        others.  Every rank's block has the same shape."""
        import torch
        mine = block.detach().to("cpu", torch.float32).contiguous()
        at = torch.tensor(where, dtype=torch.int64)
        blocks = ([torch.empty_like(mine) for _ in range(self.world)]
                  if self.rank == 0 else None)
        ats = ([torch.empty_like(at) for _ in range(self.world)]
               if self.rank == 0 else None)
        self._dist.gather(at, ats, dst=0, group=self._group)
        self._dist.gather(mine, blocks, dst=0, group=self._group)
        if self.rank != 0:
            return None
        whole = torch.full(shape, float("nan"), dtype=torch.float32)
        for (r0, r1, c0, c1), b in zip((a.tolist() for a in ats), blocks):
            whole[r0:r1, c0:c1] = b
        return whole
