#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size, in one process:

* sound runs: for each of ``--seeds`` seeds, the program's calls that a
  run with that seed would check (the same bits, draws and seeds as
  ``run.py``'s first ``check_calls`` calls) against the float64 plain
  reference;
* the control: for each of ``--control-seeds`` seeds, the reference
  computed in bfloat16 (:mod:`perfbench.reference.plainlink`) put in the
  program's place, against the float64 reference, on the same calls (one
  card is enough).

A cell of several cards takes ``--seeds 0`` here: its sound readings are
its runs' checks, which ``run.py`` prints.

    python3 perfbench/set_limits.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--out FILE]

Prints one line a seed and, last, the largest sound reading and the
smallest control reading of each compared number.  The benchmark's own
runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402  (sets the Triton cache first)
from perfbench.pbcore import cells, compare, draws  # noqa: E402


def readings(name: str, seeds, control_seeds, device="cuda:0",
             overrides: dict = None, log=print) -> dict:
    import torch
    c = cells.cell(name, (overrides or {}).get("traffic"))
    traffic = c.traffic
    cfg, dev = c.cfg, torch.device(device)
    n, C = int(traffic["samples"]), int(traffic["channels"])
    n_bits = n // cfg["params"]["sps"]
    out = {"sound": [], "control": []}
    if seeds and c.chips > 1:
        raise ValueError(f"{name} runs on {c.chips} cards: its sound "
                         "readings are its runs' checks (run.py)")

    def calls(seed):
        pool = draws.bits_pool(seed, traffic["pool"], C, n_bits)
        for k in range(int(traffic["check_calls"])):
            yield k, pool[k % len(pool)]

    def channel(seed, k, ch):
        return draws.channel_draws(cfg, n, seed, draws.CALL, k, ch, dev)

    if seeds:
        prog = run.build_program(c, traffic, dev)[0]
        captured = []
        prog.register_forward_hook(
            lambda _m, _i, out: captured.append(out[0]))
    for seed in seeds:
        rows, t = [], time.perf_counter()
        for k, bits in calls(seed):
            captured.clear()
            d = draws.call_draws(cfg, n, C, seed, draws.CALL, k, dev)
            res = c.entry.call(prog, bits, draws.derive(seed, draws.CALL, k),
                               d, traffic)
            vs = list(captured)
            for ch in range(C):
                ref = c.reference.run(cfg, traffic, bits[ch], d[ch], dev)
                rows.append(compare.row(c.entry, res[ch], vs[ch], ref))
            del vs, d
        w = compare.worst(rows, c.entry.NAMES)
        out["sound"].append(dict(seed=seed, **w))
        log(f"sound seed {seed} ({time.perf_counter() - t:.1f} s): {w}")
    if seeds:
        del prog
        captured.clear()
    for seed in control_seeds:
        rows, t = [], time.perf_counter()
        for k, bits in calls(seed):
            for ch in range(C):
                d = channel(seed, k, ch)
                ref = c.reference.run(cfg, traffic, bits[ch], d, dev)
                low = c.reference.run(cfg, traffic, bits[ch], d, dev,
                                      precision="bfloat16")
                rows.append(compare.row(c.entry, low, low["v"], ref))
                del ref, low, d
        w = compare.worst(rows, c.entry.NAMES)
        out["control"].append(dict(seed=seed, **w))
        log(f"control seed {seed} ({time.perf_counter() - t:.1f} s): {w}")
    out["lower"] = {k: max(r[k] for r in out["sound"])
                    for k in c.entry.NAMES} if out["sound"] else {}
    out["upper"] = {k: min(r[k] for r in out["control"])
                    for k in c.entry.NAMES} if out["control"] else {}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    s0 = a.first_seed
    res = readings(a.workload, range(s0, s0 + a.seeds),
                   range(s0 + 1000, s0 + 1000 + a.control_seeds))
    res["workload"] = a.workload
    line = json.dumps(run._finite(res))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(json.dumps(run._finite({k: res[k] for k in ("lower", "upper")})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
