"""The port's profiling hooks (opticomlib_tpu_torch.utils.profiling) on the
CPU: a Chrome trace of a block with its named region in it, the wall timer,
and the busy-interval bookkeeping; the names are the JAX module's."""
import glob
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from opticomlib_tpu.utils import profiling as jprofiling
from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_public_names():
    assert set(profiling.__all__) == set(jprofiling.__all__)
    assert callable(profiling.device_busy) and callable(profiling.profiled)


def test_trace_writes_a_chrome_trace_with_the_region(tmp_path):
    n = 4096
    A = torch.ones(n, dtype=torch.complex64) * 0.1
    w = 2 * np.pi * np.fft.fftfreq(n) * 160e9
    logdir = tmp_path / "trace" / "nested"      # made when missing
    with profiling.trace(str(logdir)):
        with profiling.annotate("ssfm"):
            out, steps = ssfm.ssfm_propagate(A, w, 2.0, beta_2=-20,
                                             gamma=1.3, h=0.5)
    assert steps == 4 and torch.isfinite(out.abs()).all()
    files = glob.glob(str(logdir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ssfm" in names
    assert any(str(nm).startswith("aten::") and "fft" in str(nm)
               for nm in names)
    # a second trace of the same directory is a second file
    with profiling.trace(str(logdir)):
        pass
    assert len(glob.glob(str(logdir / "trace_*.json"))) == 2


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("nothing"):
        x = torch.ones(3).sum()
    assert x == 3


def test_device_timer_brackets_the_block():
    with profiling.DeviceTimer("cpu") as t:
        time.sleep(0.05)
        y = torch.ones(8) * 2
        assert t.sync(y) is None
    assert 0.05 <= t.elapsed < 1.0
    with profiling.DeviceTimer() as t2:        # no card: nothing to wait for
        pass
    assert 0 <= t2.elapsed < 0.05


def _ev(name, a, b, cuda=True):
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(
        start=a, end=b, elapsed_us=lambda: b - a))


def test_device_busy_is_the_union_of_the_device_intervals():
    """Overlapping, nested, touching and disjoint intervals; host events do
    not count."""
    prof = SimpleNamespace(events=lambda: [
        _ev("k1", 0, 10), _ev("k2", 5, 12), _ev("k1", 6, 8),
        _ev("copy", 12, 13), _ev("k2", 20, 25), _ev("host", 0, 100, False)])
    busy, n_ops, by_name = profiling.device_busy(prof)
    assert busy == 13 + 5 and n_ops == 5
    assert by_name == {"k1": (12, 2), "k2": (12, 2), "copy": (1, 1)}
    assert profiling.device_busy(SimpleNamespace(events=lambda: [])) == (
        0.0, 0, {})
