"""scripts/torch_bench_shard_crossover.py on 2 gloo ranks on the CPU, at
2^12 and 2^13 samples: the file it writes has the JAX script's cells, with
the JAX package's halo widths, and the world size and device; it never
writes the JAX package's CROSSOVER.json."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_bench_shard_crossover.py")
TIME_LIMIT = 300


def _run(*args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return subprocess.run([sys.executable, SCRIPT, *args], env=env,
                          capture_output=True, text=True, timeout=TIME_LIMIT)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("crossover") / "CROSSOVER_CPU.json"
    p = _run("--ranks", "2", "--device", "cpu", "--sizes", "12,13",
             "--reps", "1", "--out", str(out))
    assert p.returncode == 0, p.stdout + p.stderr
    with open(out) as f:
        return json.load(f), p.stdout


def test_format_and_cells(two_ranks):
    from opticomlib_tpu.parallel.halo import halo_width
    data, said = two_ranks
    assert data["backend"] == "gloo" and data["world_size"] == 2
    assert data["device"]["type"] == "cpu" and data["reps"] == 1
    assert "two or more cards" in data["note"]
    assert [(c["n_log2"], c["shape"]) for c in data["cells"]] == [
        (12, "config2"), (12, "config4_span"), (13, "config2"),
        (13, "config4_span")]
    for c in data["cells"]:
        h = 1.0 if c["shape"] == "config2" else 0.5
        assert c["halo_H"] == halo_width(h, -21.0, 0.0, data["fs"])
        assert c["block"] == 2 ** c["n_log2"] // 2
        assert c["halo_frac"] == round(2 * c["halo_H"] / c["block"], 4)
        for method in ("pencil", "overlap"):
            m = c[method]
            assert m["wall_s"] > 0 and m["samples_per_s"] > 0
            assert m["n_steps"] == round(12 / h)
        assert c["overlap_speedup"] == round(
            c["pencil"]["wall_s"] / c["overlap"]["wall_s"], 3)
    assert said.count("[crossover] n=2^") == 4


def test_refuses_the_jax_record():
    p = _run("--device", "cpu", "--out", os.path.join(ROOT,
                                                      "CROSSOVER.json"))
    assert p.returncode == 2 and "CROSSOVER.json" in p.stderr
