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

A cell of more than one card runs one process a card
(:mod:`perfbench.pbcore.ranks`): this process imports no ``torch`` and
starts the ranks at once, each this file again on ``cuda:<rank>``, which
look for the cards and make the same calls in lockstep; rank 0 decides
when the window ends, and its result is printed here.  The kernels are
built by rank 0 while the others wait; each rank keeps Triton's kernels
in a directory of its own.

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

# no torch here: the parent of a run over several cards only waits
from perfbench.pbcore import cells, compare, ranks  # noqa: E402

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


def _device_info(torch, dev, peak, count: int = 1) -> dict:
    return dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
                count=count, memory_peak_bytes=int(peak))


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _log(msg: str) -> None:
    """``msg`` on standard error in one write, so that the lines of ranks
    that share it do not interleave."""
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


class RankFailed(Exception):
    """A rank of a run over several cards failed; no result."""

    def __init__(self, code: int):
        super().__init__(f"a rank failed (code {code})")
        self.code = code


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict = None, log=None, team=None,
             t_start: float = None) -> dict:
    """One run of the cell ``name``; returns the result line's dict.
    ``device=None`` is a benchmark run: it needs the cards the cell asks
    for.  ``device`` and ``overrides`` (``{"traffic": {...}}``, keys of the
    traffic mix replaced) let the tests drive the same run on the CPU at a
    small size.

    A cell of more than one card starts its ranks at once
    (:func:`_launch`) and returns rank 0's result, or raises
    :class:`RankFailed`.  In a rank (:func:`_rank_main`, which has looked
    for the cards), ``team`` is its :class:`~perfbench.pbcore.ranks.Team`
    and ``t_start`` the parent's start; a rank other than 0 returns
    ``None``."""
    t_in = time.perf_counter()
    log = log or _log
    chips = int(cells.workload(name)["chips"])
    if team is None and chips > 1:
        # the ranks look for the cards and load the cell's files; this
        # process only waits
        return _launch(name, seed, seconds, trace, chips, device,
                       overrides, log)
    import torch
    from perfbench.pbcore import draws
    if team is None:
        _ready(torch, chips, device)
        device = device or "cuda:0"
    c = cells.cell(name, (overrides or {}).get("traffic"))
    traffic = c.traffic
    dev = torch.device(team.device if team is not None else device)
    cuda = dev.type == "cuda"

    # ---- set-up (from this process's start, or the parent's) ----
    origin = T_START if t_start is None else t_start
    torch.set_num_threads(2)
    cfg = c.cfg
    if team is not None and cuda:
        if team.rank == 0:
            _build_kernels()
        team.barrier()   # the others then find them built
    prog, n, n_bits, C = build_program(c, traffic, dev)
    pool = draws.bits_pool(seed, traffic["pool"], C, n_bits)
    # a rank draws the noise of its own channels only
    mine = c.entry.channels(prog, C) if team is not None else None
    t_built = time.perf_counter()

    def one_call(k: int, key: int):
        return c.entry.call(prog, pool[k % len(pool)],
                            draws.derive(seed, key, k),
                            draws.call_draws(cfg, n, C, seed, key, k, dev,
                                             mine),
                            traffic)

    for k in range(int(traffic["warmup_calls"])):
        one_call(k, draws.WARM)
    t_warm = time.perf_counter()
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
    handle = (c.entry.capture(prog, hook) if hasattr(c.entry, "capture")
              else prog.register_forward_hook(hook))
    check_rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, draws.CHECK]))
    n_check = int(traffic["check_calls"])
    kept = {}
    if cuda:
        torch.cuda.synchronize(dev)
    if team is not None:
        team.barrier()

    # ---- the window ----
    walls, results = [], []
    traced = []
    t0 = time.perf_counter()
    setup_s = t0 - origin
    if team is not None:
        log(f"[perfbench] rank {team.rank} (pid {os.getpid()}): the window "
            f"opens")
    k = 0
    while True:
        go = k == 0 or time.perf_counter() - t0 < seconds
        tracing = prof is not None and (
            k == 0 or time.perf_counter() - t0 < traffic["trace_seconds"])
        if team is not None:   # rank 0's clock decides, for every rank
            go, tracing = team.agree(go, tracing)
        if not go:
            break
        slot = _pick_sample(check_rng, k, n_check)
        keep[0] = slot is not None
        captured.clear()
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
    count, where, peak_all = 1, None, peak
    if team is not None:
        count, where = team.world, c.entry.block(prog, C)
        peak_all = team.reduce(peak, "max")   # the fullest card
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted = k
    failed = sum(1 for res in results if not all(ch["ok"] for ch in res))
    out = dict(correct=False, attempted=attempted, failed=failed,
               metrics={}, device=_device_info(torch, dev, peak_all, count))

    # ---- metrics ----
    if not trace:
        ctx = SimpleNamespace(
            setup_s=setup_s, walls=walls, n_calls=attempted,
            window_s=t_end - t0, samples_per_call=n * C)
        readers = c.end_to_end
    else:
        s = tr.summarize(prof, len(traced))
        readers = c.per_layer if s is not None else []
        busy_s, window_s = (s["busy_s"], s["window_s"]) if s else (0.0, 0.0)
        if team is not None and cuda:
            # the device's busy and traced seconds, averaged over the cards
            busy_s, window_s = (team.reduce(busy_s, "mean"),
                                team.reduce(window_s, "mean"))
        if s is not None:
            if cuda:
                out["device"].update(busy_s=busy_s, window_s=window_s)
                out["breakdown"] = dict(device_ops=s["device_ops"],
                                        idle_gaps=s["idle_gaps"])
            # the per-layer metrics read this rank's trace (rank 0's)
            ctx = SimpleNamespace(
                cfg=cfg, traffic=traffic, entry=c.entry, n=n,
                n_bits=n_bits, channels=C, world=count, calls=traced,
                n_calls=len(traced), busy_s=s["busy_s"] if cuda else None,
                window_s=s["window_s"], kernels=s["kernels"], dtoh=s["dtoh"],
                events=s["events"])
    for m, reader in readers:
        val = reader.read(ctx)
        if val is not None:
            out["metrics"][m["name"]] = dict(value=float(val), unit=m["unit"])
    q = np.percentile(walls, [0, 50, 95, 100])
    who = "" if team is None else f" rank {team.rank}"
    log(f"[perfbench] {name} seed {seed}{who}: {attempted} calls in "
        f"{t_end - t0:.3f} s (call min / median / p95 / max "
        f"{' / '.join(f'{x:.4f}' for x in q)} s), set-up {setup_s:.3f} s "
        f"(in at {t_in - origin:.3f} s, link built at "
        f"{t_built - origin:.3f} s, warm-up calls done at "
        f"{t_warm - origin:.3f} s), peak "
        f"{peak / 2**30:.4f} GiB, {_power_limit() if cuda else 'cpu'}")
    t_ref = time.perf_counter()

    # ---- correctness: the kept calls against the plain reference ----
    if team is not None:
        # each rank's block of the kept calls' voltages, whole on rank 0
        kept = {slot: (kk, _whole(team, vs, where, (C, n)))
                for slot, (kk, vs) in sorted(kept.items())}
        log(f"[perfbench] rank {team.rank}: blocks gathered in "
            f"{time.perf_counter() - t_ref:.3f} s")
        if team.rank != 0:
            return None
    rows = []
    for slot in sorted(kept):
        kk, vs = kept[slot]
        for ch in range(C):
            d = draws.channel_draws(cfg, n, seed, draws.CALL, kk, ch, dev)
            ref = c.reference.run(cfg, traffic, pool[kk % len(pool)][ch],
                                  d, dev)
            rows.append(compare.row(
                c.entry, results[kk][ch] if ch < len(results[kk]) else None,
                vs[ch] if ch < len(vs) else None, ref))
            del ref, d
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


def _build_kernels() -> None:
    from opticomlib_tpu_torch.ops import _build
    _build.build()


def _whole(team, vs: list, where: tuple, shape: tuple) -> list:
    """The channels of ``shape`` whole on rank 0 from every rank's block
    (``vs[0]``, ``where`` it lies; NaN where a rank captured none)."""
    import torch
    r0, r1, c0, c1 = where
    block = vs[0] if vs else torch.full((r1 - r0, c1 - c0), float("nan"))
    whole = team.assemble(block, where, shape)
    return [] if whole is None else list(whole)


def _ready(torch, chips: int, device) -> None:
    """Refuse the run without the program, or, on the cards (``device``
    ``None``), with fewer than ``chips`` of them."""
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        raise Refused(f"the program {PROGRAM}/ is not in {ROOT}")
    if device is None and not torch.cuda.is_available():
        raise Refused("no CUDA card")
    if device is None and torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} here")


def _launch(name, seed, seconds, trace, chips, device, overrides,
            log) -> dict:
    """The ranks of a cell of ``chips`` cards, each this file again on its
    card (``device`` ``None``) or on the CPU over gloo (``"cpu"``, the
    tests); rank 0's result, its checks logged again last."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        result = Path(tmp) / "result.json"
        rank = dict(t_start=T_START, out=str(result), device=device,
                    overrides=overrides)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload",
               name, "--seed", str(seed), "--seconds", repr(float(seconds)),
               "--trace", str(int(trace)), "--rank", json.dumps(rank)]
        log(f"[perfbench] {chips} ranks start at "
            f"{time.perf_counter() - T_START:.3f} s")
        rc = ranks.launch(cmd, chips, log)
        if rc == 2:
            raise Refused("a rank refused the run (its reason is above)")
        if rc != 0 or not result.is_file():
            raise RankFailed(rc or 1)
        out = json.loads(result.read_text())
    for k_, v in out["checks"].items():
        log(f"{k_} {v['value']!r} limit {v['limit']!r}")
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


def _forbidden_loaded() -> bool:
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] modules of JAX or of the JAX package were "
              f"loaded: {', '.join(bad)}", file=sys.stderr)
    return bool(bad)


def _rank_main(a) -> int:
    """One rank of a run over several cards.  ``--rank`` holds the
    parent's start (``t_start``), where rank 0 writes its result
    (``out``), and, for the CPU tests, ``device`` and ``overrides`` (as
    :func:`run_cell` takes them); the rank, the world's size and the
    address come from the environment (:func:`ranks.launch`).  Every rank
    waits for rank 0's check before it ends.  ``PERFBENCH_RANK_FAULT``
    names a fault of ``tests/_rank_fault.py`` to plant first: the CPU
    tests' way to break the timed path under a rank."""
    spec = json.loads(a.rank)
    rank = int(os.environ["RANK"])
    if rank > 0:
        os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" /
                                             f"triton_rank{rank}")
    fault = os.environ.get("PERFBENCH_RANK_FAULT")
    if fault:
        from perfbench.tests._rank_fault import FAULTS
        FAULTS[fault](rank)
    try:
        import torch
        _ready(torch, int(os.environ["WORLD_SIZE"]), spec["device"])
        team = ranks.Team(spec["device"])
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                       device=spec["device"], overrides=spec["overrides"],
                       team=team, t_start=spec["t_start"])
    except Refused as e:
        print(f"[perfbench] rank {rank} refused: {e}", file=sys.stderr)
        return 2
    team.barrier()
    if _forbidden_loaded():
        return 3
    if out is not None:
        tmp = Path(spec["out"] + ".tmp")
        tmp.write_text(json.dumps(_finite(out)))
        os.replace(tmp, spec["out"])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a run over several cards (ranks.launch starts it)
    ap.add_argument("--rank", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return _rank_main(a)
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"[perfbench] refused: {e}", file=sys.stderr)
        return 2
    except RankFailed as e:
        print(f"[perfbench] no result: {e}", file=sys.stderr)
        return e.code
    if _forbidden_loaded():
        return 3
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
