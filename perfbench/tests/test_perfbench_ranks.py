"""The run over several ranks on the CPU, the four-card cell at its CPU size
over 4 gloo ranks (``device="cpu"``; the card's look is skipped, the rest
of the launch is the benchmark's own; its sound run is
``test_perfbench_correct.py``'s): a fault planted under the timed path in
the ranks makes it not correct; a rank killed in the
window ends the run non-zero within its limit, with no result and no
process left; a cell of one card makes no ``torch.distributed`` call; a
cell of four cards is refused on one card."""
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from perfbench import run
from perfbench.pbcore import ranks
from perfbench.tests.conftest import BENCH, ROOT, small

SEED = 2**32 + 91
CELL = "ook_50km.wdm16_2e24_4chip"
OPENS = re.compile(r"rank (\d+) \(pid (\d+)\): the window opens")


def _run(cell, seed=SEED, **kw):
    return run.run_cell(cell, seed, 0.0, False, device="cpu",
                        overrides=small(cell), log=lambda m: None, **kw)


@pytest.mark.parametrize("fault", ["block_altered", "half_channels",
                                   "frozen_fiber", "no_exchange",
                                   "errors_altered"])
def test_a_fault_in_the_ranks_is_not_correct(fault, monkeypatch):
    monkeypatch.setenv("PERFBENCH_RANK_FAULT", fault)
    out = _run(CELL)
    assert out["device"]["count"] == 4
    assert not out["correct"], (fault, out["checks"])


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_a_killed_rank_ends_the_run_without_a_result():
    cmd = [sys.executable, "-c",
           "import json, sys\n"
           "from perfbench import run\n"
           "out = run.run_cell(sys.argv[1], int(sys.argv[2]), 600.0, False, "
           "device='cpu', overrides=json.loads(sys.argv[3]))\n"
           "print(json.dumps(out))\n",
           CELL, str(SEED + 2), json.dumps(small(CELL, warmup_calls=0))]
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    pids, err = {}, []
    try:
        while len(pids) < 4:
            line = p.stderr.readline()
            if not line:
                break
            err.append(line)
            for r, pid in OPENS.findall(line):
                pids[int(r)] = int(pid)
        assert len(pids) == 4, "".join(err[-20:])
        time.sleep(1.0)   # into the window's calls
        os.kill(pids[2], signal.SIGKILL)
        t_kill = time.monotonic()
        out, rest = p.communicate(timeout=120)
        took = time.monotonic() - t_kill
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode not in (0, None), rest[-2000:]
    assert out == ""
    assert took <= ranks.END_LIMIT_S, took
    assert all(_gone(pid) for pid in pids.values()), pids


def test_a_one_card_cell_makes_no_distributed_call(monkeypatch):
    import torch.distributed as dist

    def called(*a, **k):
        raise AssertionError("a one-card run called torch.distributed")
    for name in ("init_process_group", "new_group", "barrier", "broadcast",
                 "all_reduce", "all_gather", "gather", "all_to_all_single"):
        monkeypatch.setattr(dist, name, called)
    monkeypatch.setattr(ranks, "launch", called)
    cell = next(w["name"] for w in BENCH["workloads"] if w["chips"] == 1)
    out = _run(cell)
    assert out["correct"] and out["device"]["count"] == 1, out["checks"]


def test_a_four_card_cell_is_refused_on_one_card(monkeypatch):
    """The ranks start at once and each looks for the cards (here it finds
    one): the run exits 2 without a result, and this process imported no
    ``torch`` to look."""
    monkeypatch.setenv("PERFBENCH_RANK_FAULT", "one_card")
    code = ("import sys\n"
            "from perfbench import run\n"
            "rc = run.main(sys.argv[1:])\n"
            "sys.exit(rc if 'torch' not in sys.modules else 99)\n")
    p = subprocess.run([sys.executable, "-c", code, "--workload", CELL,
                        "--seed", str(SEED), "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2, p.stderr[-2000:]
    assert p.stdout == "" and "the cell needs 4 cards, 1 here" in p.stderr


def test_control_fails_the_four_card_cells_limits():
    """The bfloat16 reference in the program's place, on the 16 channels
    of the checked call, fails a limit; the sound readings of a cell of
    several cards come from its runs."""
    from perfbench import set_limits
    from perfbench.pbcore import cells, compare
    c = cells.cell(CELL)
    r = set_limits.readings(CELL, [], [SEED + 3], device="cpu",
                            overrides=small(CELL), log=lambda m: None)
    assert not compare.judge(r["upper"], c.limits), r["upper"]
    with pytest.raises(ValueError):
        set_limits.readings(CELL, [SEED], [], device="cpu",
                            overrides=small(CELL))
