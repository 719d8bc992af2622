#!/usr/bin/env python3
"""Run one cell of the benchmark as ``run.py --trace 1`` runs it, with the
program's span recorder on, and cut the device trace by span:

    python3 perfbench/run_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--spans 0|1]

The run is :func:`perfbench.run.run_cell`'s traced run; around it, span
recording (``opticomlib_tpu_torch.utils.profiling.record``) is turned on
before the program is built and drained after the window, and the host's
clock is read when the trace starts and stops.  The last line of standard
output is ``run.py``'s result line, with:

* in ``metrics``, the span metrics (:data:`SPAN_METRICS`, each read by
  ``metrics/<name>.py`` from the spans and from
  :func:`perfbench.pbcore.spans.by_span`);
* in ``breakdown``, beside ``device_ops`` and ``idle_gaps``:
  ``busy_by_span``, ``idle_by_span`` (s), ``launches_by_span`` and
  ``readbacks_by_span`` (over the traced calls);
* ``spans``: the calls counted, the cut's totals beside the trace's
  (``busy_s``, idle, read-backs: they add up), the share of the idle time
  that fell outside every span, and the host-clock median of the entry
  call's wall over the traced calls and over the rest of the window.

``--spans 0`` makes the same run with the recorder off, so that two runs
give what recording costs a call.  Exits 2 without a card, as ``run.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402
from perfbench.pbcore import cells, spans, trace  # noqa: E402

#: the span metrics and their units
SPAN_METRICS = {"fiber.busy_ms_per_call": "ms",
                "fiber.idle_ms_per_call": "ms",
                "rx.busy_ms_per_call": "ms",
                "rx.idle_ms_per_call": "ms",
                "rx.readbacks_per_call": "syncs/call",
                "setup.link_build_s": "s"}


def _ranked(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]


def traced_run(name: str, seed: int, seconds: float, record: bool = True,
               device=None, overrides: dict = None) -> dict:
    """One traced run of the cell ``name`` (``run_cell``'s arguments),
    spans recorded when ``record``; returns the result line's dict."""
    from opticomlib_tpu_torch.utils import profiling

    held = {}
    make = trace.profiler

    def profiler(cuda):
        prof = make(cuda)
        start, stop = prof.start, prof.stop

        def on():
            held["on"] = time.time_ns()
            start()

        def off():
            stop()
            held["off"] = time.time_ns()
        prof.start, prof.stop = on, off
        held["prof"] = prof
        return prof

    c = cells.cell(name, (overrides or {}).get("traffic"))
    call, walls = c.entry.call, []

    def timed(*args, **kw):
        t0 = time.time_ns()
        try:
            return call(*args, **kw)
        finally:
            walls.append((t0, time.time_ns()))

    trace.profiler, c.entry.call = profiler, timed
    profiling.record(record)
    try:
        out = run.run_cell(name, seed, seconds, True, device=device,
                           overrides=overrides)
        recs = profiling.drain()
    finally:
        profiling.record(False)
        trace.profiler, c.entry.call = make, call

    prof, on, off = held["prof"], held["on"], held["off"]
    inside = [(b - a) / 1e6 for a, b in walls if on <= a and b <= off]
    rest = [(b - a) / 1e6 for a, b in walls if not (on <= a and b <= off)]
    info = dict(traced_call_median_ms=statistics.median(inside)
                if inside else None,
                untraced_call_median_ms=statistics.median(rest)
                if rest else None, records=len(recs))
    cut = spans.by_span(prof, recs, (on, off)) if recs else None
    ctx = SimpleNamespace(spans=recs or None, span_cut=cut)
    for m, unit in SPAN_METRICS.items():
        val = cells.load_module(cells.HERE / "metrics" / (m + ".py"),
                                "metric").read(ctx)
        if val is not None:
            out["metrics"][m] = dict(value=float(val), unit=unit)
    if cut is not None:
        s = trace.summarize(prof, len(inside))
        out.setdefault("breakdown", {}).update(
            busy_by_span=_ranked(cut["busy_by_span"]),
            idle_by_span=_ranked(cut["idle_by_span"]),
            launches_by_span=_ranked(cut["launches_by_span"]),
            readbacks_by_span=_ranked(cut["readbacks_by_span"]))
        idle = s["window_s"] - s["busy_s"]
        info.update(
            calls=cut["calls"], busy_s=cut["busy_s"],
            trace_busy_s=s["busy_s"], idle_s=cut["idle_s"],
            trace_idle_s=idle,
            readbacks=sum(cut["readbacks_by_span"].values()),
            trace_dtoh=s["dtoh"],
            launches=sum(cut["launches_by_span"].values()),
            trace_kernels=s["kernels"],
            outside_idle_share=(cut["idle_by_span"].get(spans.OUTSIDE, 0.0)
                                / idle if idle > 0 else None))
    out["spans"] = info
    # the checks stay last, as run.py prints them
    out["checks"] = out.pop("checks")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    try:
        out = traced_run(a.workload, a.seed, a.seconds, bool(a.spans))
    except run.Refused as e:
        print(f"[perfbench] refused: {e}", file=sys.stderr)
        return 2
    bad = run.forbidden_modules()
    if bad:
        print(f"[perfbench] modules of JAX or of the JAX package were "
              f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(run._finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
