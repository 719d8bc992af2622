#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it is started
on, and print one JSON line of results as the last line of standard
output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; every file of the cell is found by those names (see
:mod:`perfbench.pbcore.cells`).  The run:

1. exits non-zero, printing no result, without a CUDA card (or with fewer
   cards than the cell asks for), or where the program under test
   (``opticomlib_tpu_torch``, beside this folder) is missing;
2. set-up: builds the program's kernels, the link at the cell's size, the
   pool of bits from ``--seed``, and makes the traffic's warm-up calls, so
   that nothing builds or compiles later;
3. the window: calls back to back for ``--seconds`` (one client, a closed
   loop); call ``k`` takes bits ``k mod pool`` and fresh unit noise draws
   from a generator seeded from ``(--seed, k)``, made on the card inside
   the call's time;  with ``--trace 1`` the calls of the traffic's first
   ``trace_seconds`` run under ``torch.profiler``;
4. after the window: reads the peak device memory, frees the program and
   runs the plain reference (``reference/<config>.py``, float64) on a
   sample of the window's calls drawn from the seed, holding what the
   timed path produced to it (the numbers the entry driver names,
   :mod:`perfbench.pbcore.compare`, limits in ``limits/<cell>.json``);
   prints each number beside its limit;
5. fails the run if a module of JAX or of the JAX package was loaded.

With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones; each is read by ``metrics/<name>.py``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the program's Triton cache at a fixed place inside the checkout, beside
# its nvcc builds (build/kernels)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

import numpy as np  # noqa: E402

from perfbench.pbcore import cells, compare, draws  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "opticomlib_tpu")
PROGRAM = "opticomlib_tpu_torch"


class Refused(Exception):
    """The run cannot be made here; no result is printed."""


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package (the part before the first dot, compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _pick_sample(rng, k: int, size: int):
    """Reservoir sampling: whether call ``k`` joins the ``size`` kept
    calls, and in which slot."""
    if k < size:
        return k
    j = int(rng.integers(0, k + 1))
    return j if j < size else None


def _device_info(torch, dev, peak) -> dict:
    return dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
                count=1, memory_peak_bytes=int(peak))


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict = None, log=None) -> dict:
    """One run of the cell ``name``; returns the result line's dict.
    ``device=None`` is a benchmark run: it needs the cards the cell asks
    for.  ``device`` and ``overrides`` (``{"traffic": {...}}``, keys of the
    traffic mix replaced) let the tests drive the same run on the CPU at a
    small size."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    c = cells.cell(name, (overrides or {}).get("traffic"))
    traffic = c.traffic
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        raise Refused(f"the program {PROGRAM}/ is not in {ROOT}")
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card")
        if torch.cuda.device_count() < c.chips:
            raise Refused(f"the cell needs {c.chips} cards, "
                          f"{torch.cuda.device_count()} here")
        device = "cuda:0"
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # ---- set-up ----
    torch.set_num_threads(2)
    cfg = c.cfg
    prog, n, n_bits, C = build_program(c, traffic, dev)
    pool = draws.bits_pool(seed, traffic["pool"], C, n_bits)
    t_built = time.perf_counter()

    def one_call(k: int, key: int):
        return c.entry.call(prog, pool[k % len(pool)],
                            draws.derive(seed, key, k),
                            draws.call_draws(cfg, n, C, seed, key, k, dev),
                            traffic)

    for k in range(int(traffic["warmup_calls"])):
        one_call(k, draws.WARM)
    prof = None
    if trace:
        from perfbench.pbcore import trace as tr
        tr.warm(cuda, dev)
        prof = tr.profiler(cuda)

    # the timed path's voltages of the kept calls, held by reference
    captured, keep = [], [False]

    def hook(_mod, _inp, out):
        if keep[0]:
            captured.append(out[0])
    handle = prog.register_forward_hook(hook)
    check_rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, draws.CHECK]))
    n_check = int(traffic["check_calls"])
    kept = {}
    if cuda:
        torch.cuda.synchronize(dev)

    # ---- the window ----
    walls, results = [], []
    traced = []
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    k = 0
    while k == 0 or time.perf_counter() - t0 < seconds:
        slot = _pick_sample(check_rng, k, n_check)
        keep[0] = slot is not None
        captured.clear()
        tracing = prof is not None and (
            k == 0 or time.perf_counter() - t0 < traffic["trace_seconds"])
        if tracing and k == 0:
            prof.start()
        elif prof is not None and not tracing and len(traced) == k:
            prof.stop()  # the traced calls are over
        t1 = time.perf_counter()
        res = one_call(k, draws.CALL)
        walls.append(time.perf_counter() - t1)
        if tracing:
            traced.append(res)
        results.append(res)
        if keep[0]:
            kept[slot] = (k, list(captured))
        k += 1
    t_end = time.perf_counter()
    if prof is not None and len(traced) == k:
        prof.stop()
    handle.remove()
    keep[0] = False
    captured.clear()

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted = k
    failed = sum(1 for res in results if not all(ch["ok"] for ch in res))
    out = dict(correct=False, attempted=attempted, failed=failed,
               metrics={}, device=_device_info(torch, dev, peak))

    # ---- metrics ----
    if not trace:
        ctx = SimpleNamespace(
            setup_s=setup_s, walls=walls, n_calls=attempted,
            window_s=t_end - t0, samples_per_call=n * C)
        readers = c.end_to_end
    else:
        s = tr.summarize(prof, len(traced))
        readers = c.per_layer if s is not None else []
        if s is not None:
            if cuda:
                out["device"].update(busy_s=s["busy_s"],
                                     window_s=s["window_s"])
                out["breakdown"] = dict(device_ops=s["device_ops"],
                                        idle_gaps=s["idle_gaps"])
            ctx = SimpleNamespace(
                cfg=cfg, traffic=traffic, entry=c.entry, n=n,
                n_bits=n_bits, channels=C, calls=traced,
                n_calls=len(traced), busy_s=s["busy_s"] if cuda else None,
                window_s=s["window_s"], kernels=s["kernels"], dtoh=s["dtoh"])
    for m, reader in readers:
        val = reader.read(ctx)
        if val is not None:
            out["metrics"][m["name"]] = dict(value=float(val), unit=m["unit"])
    q = np.percentile(walls, [0, 50, 95, 100])
    log(f"[perfbench] {name} seed {seed}: {attempted} calls in "
        f"{t_end - t0:.3f} s (call min / median / p95 / max "
        f"{' / '.join(f'{x:.4f}' for x in q)} s), set-up {setup_s:.3f} s "
        f"(link built at {t_built - T_START:.3f} s), peak "
        f"{peak / 2**30:.4f} GiB, {_power_limit() if cuda else 'cpu'}")
    t_ref = time.perf_counter()

    # ---- correctness: the kept calls against the plain reference ----
    rows = []
    for slot in sorted(kept):
        kk, vs = kept[slot]
        d = draws.call_draws(cfg, n, C, seed, draws.CALL, kk, dev)
        for ch in range(C):
            ref = c.reference.run(cfg, traffic, pool[kk % len(pool)][ch],
                                  d[ch], dev)
            rows.append(compare.row(
                c.entry, results[kk][ch] if ch < len(results[kk]) else None,
                vs[ch] if ch < len(vs) else None, ref))
            del ref
        del d
    checks = compare.worst(rows, c.entry.NAMES)
    out["correct"] = bool(rows) and failed == 0 and compare.judge(
        checks, c.limits)
    out["checks"] = {k_: dict(value=v, limit=c.limits.get(k_))
                     for k_, v in checks.items()}
    log(f"[perfbench] reference on {len(rows)} channel(s) of "
        f"{len(kept)} call(s): {time.perf_counter() - t_ref:.3f} s")
    for k_, v in checks.items():
        log(f"{k_} {v!r} limit {c.limits.get(k_)!r}")
    return out


def build_program(c, traffic: dict, dev):
    """The program of the cell ``c`` at its traffic's size on ``dev``
    (the kernels built first on a card): ``(program, samples a channel,
    bits a channel, channels)``."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.params import SimParams
    if dev.type == "cuda":
        from opticomlib_tpu_torch.ops import _build
        _build.build()
    sps = c.cfg["params"]["sps"]
    n = int(traffic["samples"])
    params = SimParams.create(sps=sps, R=c.cfg["params"]["R"],
                              wavelength=c.cfg["params"]["wavelength"],
                              _warn=False)
    prog = c.entry.build(link, link_spec(link, c.cfg), params, n // sps,
                         traffic, dev)
    return prog, n, n // sps, int(traffic["channels"])


def link_spec(link, cfg: dict):
    """The configuration's link as the program's ``LinkSpec``: each stage
    is the program's class its ``spec`` names (a name ending in ``Spec``),
    built from the stage's other keys, and a ``RepeatSpec``'s ``stages``
    in turn; a key the class does not take is refused."""
    def stage(st):
        kw = dict(st)
        name = kw.pop("spec")
        cls = getattr(link, name, None) if name.endswith("Spec") else None
        if not isinstance(cls, type) or name == "LinkSpec":
            raise ValueError(f"unknown stage spec {name!r}")
        if "stages" in kw:
            kw["stages"] = tuple(stage(s) for s in kw["stages"])
        return cls(**kw)

    L = dict(cfg["link"])
    L["pulse_kwargs"] = tuple(L["pulse_kwargs"].items())
    L["stages"] = tuple(stage(s) for s in L["stages"])
    return link.LinkSpec(**L)


def _finite(x):
    """``x`` with every non-finite float written as a string, so that
    the line is strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"[perfbench] refused: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] modules of JAX or of the JAX package were "
              f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
