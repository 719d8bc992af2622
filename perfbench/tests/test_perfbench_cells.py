"""Every cell's files are found by the names in BENCHMARK.json, and the
file keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench.pbcore import cells, draws
from perfbench.tests.conftest import BENCH, CELLS, ROOT, SMALL, SWEEP

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for x in names:
        assert NAME.match(x), x
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    c = cells.cell(name)
    assert c.cfg["name"] == c.config
    assert callable(c.entry.build) and callable(c.entry.call)
    assert callable(c.entry.readings) and callable(c.reference.run)
    assert set(c.limits) == set(c.entry.NAMES)
    assert {m["name"] for m, _ in c.per_layer} >= {
        "device.idle_pct", "device.launches_per_call",
        "link.readbacks_per_call"}
    assert {m["name"] for m, _ in c.end_to_end} >= {"setup_s",
                                                   "samples_per_s"}
    assert all(callable(r.read) for _, r in c.end_to_end + c.per_layer)
    assert name in SMALL
    if c.chips > 1:   # what a rank of a run over several cards asks
        assert all(callable(getattr(c.entry, f, None))
                   for f in ("block", "channels", "capture"))


def test_traffic_keys_are_replaced_before_the_entry_loads():
    c = cells.cell("ook_50km.dsp_2e24", traffic=SWEEP)
    assert c.traffic["channels"] == 4 and c.traffic["nslots"] == 8192
    assert c.entry.__name__.endswith("dsp_wdm")


def _every_field(cls, given: dict):
    from dataclasses import fields
    return set(given) == {f.name for f in fields(cls)}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_holds_every_link_value(config):
    """Every field of the program's ``LinkSpec`` and of each stage's class
    is given, so that no default of the program applies unseen."""
    from opticomlib_tpu_torch import link
    from perfbench import run
    cfg = json.loads((ROOT / f"perfbench/configs/{config}.json").read_text())
    spec = run.link_spec(link, cfg)
    assert _every_field(link.LinkSpec, cfg["link"])

    def walk(stages, built):
        assert len(stages) == len(built)
        for st, b in zip(stages, built):
            assert type(b).__name__ == st["spec"]
            given = {k: v for k, v in st.items() if k != "spec"}
            assert _every_field(type(b), given), st["spec"]
            if "stages" in st:
                walk(st["stages"], b.stages)
    walk(cfg["link"]["stages"], spec.stages)
    assert next(c for c in BENCH["configs"] if c["name"] == config)[
        "source"] == cfg["source"]


@pytest.mark.parametrize("stage", [
    {"spec": "FiberSpec", "length": 1.0, "toll": 1e-5},   # misspelt key
    {"spec": "FibreSpec", "length": 1.0},                 # no such class
    {"spec": "LinkSpec"}, {"spec": "build_link"}])
def test_a_stage_the_program_does_not_take_is_refused(stage):
    from opticomlib_tpu_torch import link
    from perfbench import run
    cfg = json.loads((ROOT / "perfbench/configs/ook_50km.json").read_text())
    cfg["link"]["stages"] = [stage]
    with pytest.raises((TypeError, ValueError)):
        run.link_spec(link, cfg)


def test_draws_are_a_function_of_the_seed():
    cfg = cells.cell("longhaul_dbp.dsp_2e24").cfg
    names = [n for n, _ in draws.noise_rows(cfg)]
    assert names == ["phase", "rin"] + ["ase"] * 20 + ["thermal", "shot"]
    seed = draws.derive(2**33 + 5, draws.DRAWS, 7)
    a, b = draws.make(cfg, 64, seed, "cpu"), draws.make(cfg, 64, seed, "cpu")
    assert all((a[k] == b[k]).all() for k in ("phase", "rin", "shot"))
    assert len(a["ase"]) == 20 and a["ase"][3].shape == (4, 64)
    other = draws.make(cfg, 64, seed + 1, "cpu")
    assert not (other["shot"] == a["shot"]).all()
    p1 = draws.bits_pool(2**33 + 5, 8, 2, 16)
    assert (p1 == draws.bits_pool(2**33 + 5, 8, 2, 16)).all()
    assert p1.shape == (8, 2, 16) and set(p1.ravel()) <= {0, 1}
