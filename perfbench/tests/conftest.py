"""CPU tests of the benchmark harness (``python -m pytest perfbench/tests``
from the checkout's root).  Tests that need a card are marked ``cuda`` and
skip without one."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

#: the CPU size of each cell (samples a channel)
SMALL = {"ook_50km.dsp_2e24": 2**16, "longhaul_dbp.dsp_2e24": 2**14,
         "ook_50km.wdm16_2e24_4chip": 2**14}

#: a sweep of 4 channels through the ``dsp_wdm`` entry driver, in place of
#: a cell's own traffic (its limits stay the cell's)
SWEEP = dict(entry="dsp_wdm", channels=4, samples=2**14, sps_resamp=None)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(cell: str, **more) -> dict:
    """``run_cell``'s overrides for ``cell`` at its CPU size (``more``
    replaces further keys of its traffic)."""
    return {"traffic": dict(dict(samples=SMALL[cell], warmup_calls=1,
                                 check_calls=1), **more)}
