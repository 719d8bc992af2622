"""The trace reduction and the per-layer readers on a made-up trace; the
least-work count on the configurations' shapes."""
import json
import math
from types import SimpleNamespace

import pytest

from perfbench.pbcore import cells, trace, work

US = 1000  # ns


def test_summarize(monkeypatch):
    # (name, is_device, start_ns, end_ns): runtime calls on the host, a
    # kernel, a read-back and a memset on the device
    ev = [("cudaLaunchKernel", False, 0, 5 * US),
          ("kern_a", True, 10 * US, 40 * US),
          ("cudaMemcpyAsync", False, 45 * US, 62 * US),
          ("Memcpy DtoH (Device -> Pageable)", True, 50 * US, 60 * US),
          ("cudaLaunchKernel", False, 90 * US, 95 * US),
          ("kern_a", True, 95 * US, 100 * US),
          ("Memset (Device)", True, 98 * US, 99 * US)]
    monkeypatch.setattr(trace, "_raw", lambda prof: ev)
    s = trace.summarize(None, 2)
    assert math.isclose(s["window_s"], 100e-6)
    assert math.isclose(s["busy_s"], 45e-6)
    assert s["kernels"] == 2 and s["dtoh"] == 1
    assert s["device_ops"][0] == ["kern_a", pytest.approx(35e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-6)
    assert gaps["after cudaMemcpyAsync"] == pytest.approx(35e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)
    assert [e[2] for e in s["events"]] == ["kern_a", "Memcpy DtoH (Device -> "
                                           "Pageable)", "kern_a",
                                           "Memset (Device)"]


def test_readers():
    c = cells.cell("ook_50km.dsp_2e24")
    readers = {m["name"]: r for m, r in c.per_layer}
    calls = [[dict(n_steps=[58])], [dict(n_steps=[58])]]
    n, n_bits = 2**24, 2**18
    ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, entry=c.entry, n=n,
                          n_bits=n_bits, channels=1, world=1, calls=calls,
                          n_calls=2, busy_s=0.2, window_s=0.32,
                          kernels=8846, dtoh=194)
    assert readers["device.idle_pct"].read(ctx) == pytest.approx(37.5)
    assert readers["device.launches_per_call"].read(ctx) == 4423
    assert readers["link.readbacks_per_call"].read(ctx) == 97
    rx = c.entry.receiver_bytes(c.cfg, c.traffic, n, n_bits)
    assert rx == 4 * (8192 * 64 + 2 * n_bits)
    by, fl = work.channel_work(c.cfg, n, n_bits, rx, [58])
    fft_bytes = 58 * 2 * 2 * 8 * n
    assert fft_bytes < by < 1.05 * fft_bytes
    assert fl == pytest.approx(58 * 2 * 5 * n * 24)
    least = 2 * work.least_time_s(by, fl)
    assert readers["kernels.roofline_pct"].read(ctx) == pytest.approx(
        100 * least / 0.2)
    ctx.busy_s = None  # no device trace: nothing to read
    assert all(r.read(ctx) is None for r in readers.values())


def test_longhaul_counts_both_polarisations():
    c = cells.cell("longhaul_dbp.dsp_2e24")
    n = 2**24
    by, fl = work.channel_work(c.cfg, n, n // 16, 4 * 8192 * 16, [4] * 40)
    # 160 o4 steps of 3 FFT pairs on the (2, n) field
    assert by > 160 * 6 * 2 * 8 * n * 2
    assert fl == pytest.approx(160 * 6 * 2 * 5 * n * 24)


def test_end_to_end_readers():
    import numpy as np
    c = cells.cell("ook_50km.dsp_2e24")
    readers = {m["name"]: r for m, r in c.end_to_end}
    walls = [0.1] * 18 + [0.2, 0.3]
    ctx = SimpleNamespace(setup_s=20.5, walls=walls, n_calls=20,
                          window_s=2.5, samples_per_call=2**24)
    assert readers["setup_s"].read(ctx) == 20.5
    assert readers["samples_per_s"].read(ctx) == pytest.approx(
        20 * 2**24 / 2.5)
    assert readers["call_p95_ms"].read(ctx) == pytest.approx(
        1e3 * np.percentile(walls, 95))


def test_every_stage_class_is_counted():
    cfg = json.loads(json.dumps(cells.cell("ook_50km.dsp_2e24").cfg))
    n = 2**20
    cfg["link"]["stages"] = [
        {"spec": "DMSpec", "D": 100.0},
        {"spec": "BPFSpec", "BW": 40e9, "n": 4},
        {"spec": "EDFASpec", "G": 10.0, "NF": None, "BW": 40e9,
         "filt_order": 4}]
    by, fl = work.channel_work(cfg, n, n // 64, 0, [])
    assert fl == pytest.approx(6 * 5 * n * 20)   # three transform pairs
    assert by > 6 * 2 * 8 * n
    cfg["link"]["stages"] = [{"spec": "TapSpec"}]
    with pytest.raises(ValueError):
        work.channel_work(cfg, n, n // 64, 0, [])


def test_collective_share_is_the_union_of_the_nccl_kernels():
    c = cells.cell("ook_50km.wdm16_2e24_4chip")
    readers = {m["name"]: r for m, r in c.per_layer}
    read = readers["device.collective_pct"].read
    ev = [(0, 40 * US, "kern_a"),
          (10 * US, 30 * US, "ncclDevKernel_SendRecv(args)"),
          (20 * US, 50 * US, "ncclDevKernel_AllReduce_Sum_f32(args)"),
          (60 * US, 100 * US, "kern_b")]
    ctx = SimpleNamespace(busy_s=90e-6, window_s=100e-6, events=ev)
    assert read(ctx) == pytest.approx(100 * 40 / 90)
    assert trace.union_s([(s, t) for s, t, _ in ev]) == pytest.approx(90e-6)
    ctx.events = [e for e in ev if not e[2].startswith("nccl")]
    assert read(ctx) is None
    ctx.busy_s = None
    assert read(ctx) is None


def test_four_card_readers_take_a_cards_share_of_the_work():
    """Rank 0's roofline: the 16 channels' least work over the world's
    size, over its busy time; the eye's graph share from the answers."""
    c = cells.cell("ook_50km.wdm16_2e24_4chip")
    readers = {m["name"]: r for m, r in c.per_layer}
    n, n_bits = 2**24, 2**18
    calls = [[dict(n_steps=[58], eye_graph=True) for _ in range(16)]] * 3
    ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, entry=c.entry, n=n,
                          n_bits=n_bits, channels=16, world=4, calls=calls,
                          n_calls=3, busy_s=3.6, window_s=3.9)
    rx = c.entry.receiver_bytes(c.cfg, c.traffic, n, n_bits)
    by, fl = work.channel_work(c.cfg, n, n_bits, rx, [58])
    assert readers["kernels.roofline_pct"].read(ctx) == pytest.approx(
        100 * work.least_time_s(48 * by, 48 * fl) / 4 / 3.6)
    assert readers["rx.eye_graph_pct"].read(ctx) == 100.0
    ctx.calls = [[dict(ch, eye_graph=False) for ch in calls[0]]] + calls[1:]
    assert readers["rx.eye_graph_pct"].read(ctx) == pytest.approx(200 / 3)
