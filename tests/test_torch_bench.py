"""bench_cuda.py, the port's benchmark CLI, held to bench.py, the JAX
package's, both run here on the CPU at bench_cuda's ``--small`` sizes
(``bench_cuda.SMALL``: 2^12-2^16 samples, config 4 with 2 + 2 spans,
config 5 with 2 channels).

``bench.py`` is loaded as a module and left as it is: the cells that read
its module globals get ``N_BITS``, ``SPS`` and ``N`` (and the defaults of
its ``_build_ook_link``, which bind ``N_BITS`` and ``SPS`` when the module
loads) from ``monkeypatch``; the others take their sizes as arguments.  The
equal-accuracy cells read ``EQUAL_ACCURACY.json`` on both sides.

For each of the ten cells: the keys of the two results are equal (apart
from bench_cuda's measurements ``walls_s`` and ``peak_mem_gib``), and every
value is equal but the times and rates and the shortfall's wording: the
step counts, FFT pairs, steps ``h``, sample and channel counts and the
values copied from the calibration file, and the BERs (the noise is
threefry in JAX and Philox here: the same decision, zero errors, not the
same bits).  The CLI runs as a subprocess: its JSON line and file have
bench.py's keys, and it writes nothing into the repository.
"""
import fnmatch
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "bench_cuda.py")
JAX_CAL = os.path.join(ROOT, "EQUAL_ACCURACY.json")
#: bench_cuda's measurements, which bench.py does not take
ADDED = {"walls_s", "peak_mem_gib"}
#: values that differ between two runs or two devices
TIMES = {"wall_s", "samples_per_s", "sample_steps_per_s",
         "speedup_at_equal_accuracy"}
#: cells whose sizes are bench.py's module globals
GLOBAL_SIZED = {"ssfm_headline", "ssfm_equal_accuracy", "full_chain",
                "b2b_chain", "fused_dsp"}
#: bench.py's detail keys under --all with BASELINE_MEASURED.json
#: (bench.py:491-568)
BENCH_PY_DETAIL = {"n_steps", "wall_s", "equal_accuracy_samples_per_s",
                   "equal_accuracy", "full_chain_samples_per_s",
                   "full_chain_wall_s", "b2b_chain_samples_per_s", "all",
                   "baseline_denominator"}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_jax():
    return _load(os.path.join(ROOT, "bench.py"), "_bench_jax")


@pytest.fixture(scope="module")
def bench_cuda():
    return _load(SCRIPT, "_bench_cuda")


def _run_jax(bench, monkeypatch, cell, size):
    fn = getattr(bench, "bench_" + cell)
    if cell not in GLOBAL_SIZED:
        return fn(**size)
    n_bits, sps = size["n_bits"], size["sps"]
    for k, v in (("N_BITS", n_bits), ("SPS", sps), ("N", n_bits * sps)):
        monkeypatch.setattr(bench, k, v)
    monkeypatch.setattr(bench._build_ook_link, "__defaults__",
                        (n_bits, sps, 16.0))
    return fn(n_bits) if cell == "fused_dsp" else fn()


def _held(port, jax, where=""):
    """Every key of ``jax`` in ``port`` and no other but :data:`ADDED`,
    and every value equal but :data:`TIMES` and the shortfall's text."""
    assert set(port) - ADDED == set(jax), (where, set(port) ^ set(jax))
    for k, v in jax.items():
        if isinstance(v, dict):
            _held(port[k], v, f"{where}.{k}")
        elif k not in TIMES and k != "shortfall":
            assert port[k] == v, (f"{where}.{k}", port[k], v)


@pytest.mark.parametrize("cell", ["ssfm_headline", "ssfm_equal_accuracy",
                                  "full_chain", "b2b_chain", "ppm",
                                  "fused_dsp", "dbp", "dbp_o4", "wdm_batch",
                                  "wdm_shard"])
def test_cell_matches_bench_py(bench_jax, bench_cuda, monkeypatch, cell):
    size = bench_cuda.SMALL[cell]
    cal = {"cal_path": JAX_CAL} if cell in ("ssfm_equal_accuracy",
                                           "dbp_o4") else {}
    rate, port = getattr(bench_cuda, "bench_" + cell)(**size, **cal,
                                                      device="cpu")
    jax_rate, jax = _run_jax(bench_jax, monkeypatch, cell, size)
    _held(port, jax)
    reps = 3 if cell.startswith("ssfm") else 2
    assert len(port["walls_s"]) == reps
    assert port["wall_s"] == round(min(port["walls_s"]), 3)
    assert port["peak_mem_gib"] is None
    assert rate > 0 and np.isfinite(rate) and jax_rate > 0
    if cell in ("ppm", "fused_dsp"):
        assert port["ber"] == jax["ber"] == 0.0
    if cell == "wdm_batch":
        assert port["max_ber"] == jax["max_ber"] == 0.0
        assert port["n_ch"] == 2
    for key in ("n_steps", "total_steps", "fft_pairs"):
        if key in jax:
            assert port[key] == jax[key] > 0
    if cell == "ssfm_equal_accuracy":
        tight = port["tight"]
        assert tight["reference_scheme"]["fft_pairs"] > \
            tight["o4"]["fft_pairs"] == 240  # 80 steps of 0.625 km
        for row in ("reference_scheme", "o4"):
            assert len(tight[row]["walls_s"]) == 3


def _snapshot():
    """(path, size, mtime) of every file of the repository that git would
    commit: what ``.gitignore`` lists (build outputs and caches, where
    other tests write) is left out."""
    with open(os.path.join(ROOT, ".gitignore")) as f:
        pats = [ln.strip() for ln in f if ln.strip()
                and not ln.startswith("#")]
    dirs = {p.rstrip("/") for p in pats if p.endswith("/")} | {".git"}
    globs = [p for p in pats if not p.endswith("/")]
    snap = set()
    for dirpath, dirnames, files in os.walk(ROOT):
        dirnames[:] = [d for d in dirnames if d not in dirs]
        for f in files:
            if any(fnmatch.fnmatch(f, pat) for pat in globs):
                continue
            st = os.stat(os.path.join(dirpath, f))
            snap.add((os.path.join(dirpath, f), st.st_size, st.st_mtime_ns))
    return snap


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, SCRIPT, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_cli_small_all_on_cpu(tmp_path):
    out = tmp_path / "bench_all.json"
    before = _snapshot()
    run = _cli("--device", "cpu", "--small", "--all", "--out", str(out))
    assert run.returncode == 0, run.stderr
    assert _snapshot() == before, "bench_cuda.py wrote into the repository"
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "ssfm_2e24_ook_throughput"
    assert line["unit"] == "samples/s/chip" and line["value"] > 0
    detail = line["detail"]
    assert set(detail) == BENCH_PY_DETAIL | ADDED | {"device"}
    assert detail["device"]["name"] == "cpu"
    assert "not a GPU number" in detail["baseline_denominator"]["note"]
    # the equal-accuracy cell reads the card's calibration by default
    with open(os.path.join(ROOT, "EQUAL_ACCURACY_CUDA.json")) as f:
        cal = json.load(f)
    eq = detail["equal_accuracy"]
    assert eq["h_km"] == cal["o4"]["h"] and eq["fft_pairs"] == 75
    assert eq["tight"]["o4"]["h_km"] == cal["tight"]["o4"]["h"]
    assert eq["tight"]["o4"]["fft_pairs"] == 189  # 63 steps of 0.8 km

    with open(os.path.join(ROOT, "BENCH_ALL.json")) as f:
        jax_rows = json.load(f)
    with open(out) as f:
        rows = json.load(f)
    assert set(rows) == set(jax_rows) | {"device"} and len(jax_rows) == 10
    assert set(detail["all"]) == set(jax_rows)
    for k, row in jax_rows.items():
        assert set(rows[k]) - ADDED == set(row), k
    assert rows["config4_dbp_o4_roundtrip"]["fft_pairs"] == 48  # 2 + 2 spans
    assert rows["device"]["name"] == "cpu"


@pytest.mark.parametrize("args,said", [
    (("--small",), "no CUDA device"),
    (("--device", "cpu", "--small", "--all", "--out",
      os.path.join(ROOT, "BENCH_ALL.json")), "JAX package's record")])
def test_cli_refuses(args, said):
    """Without a card and without ``--device cpu`` the script exits
    non-zero before any cell; it never writes ``BENCH_ALL.json``."""
    if torch.cuda.is_available() and "--device" not in args:
        pytest.skip("a card is present")
    before = _snapshot()
    run = _cli(*args, timeout=120)
    assert run.returncode != 0
    assert said in run.stderr
    assert run.stdout == ""
    assert _snapshot() == before
