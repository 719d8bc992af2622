"""Find a cell's files by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), entry driver (``entries/<entry>.py``, the
entry named in the traffic file), plain reference
(``reference/<config>.py``), limits of the correctness check
(``limits/<cell>.json``) and the readers of its end-to-end and per-layer
metrics (``metrics/<metric>.py``, each a ``read(ctx)`` that returns the
number or ``None`` where it finds nothing to read)."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]   # perfbench/
ROOT = HERE.parent                           # the checkout
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """Import the file ``path`` under a name of its own."""
    name = "perfbench._loaded_%s_%s" % (kind, re.sub(r"\W", "_", path.stem))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _named(folder: str, name: str, suffix: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    path = HERE / folder / (name + suffix)
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} not found")
    return path


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: dict = None) -> dict:
    """The entry of ``BENCHMARK.json``'s ``workloads`` named ``name``."""
    by_name = {w["name"]: w for w in (bench or benchmark())["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    return by_name[name]


def cell(name: str, traffic: dict = None) -> SimpleNamespace:
    """Everything one cell needs, found by name; ``traffic``: keys of the
    traffic mix replaced (the tests' small sizes), before the entry it
    names is loaded."""
    bench = benchmark()
    w = workload(name, bench)
    cfg = load_json(_named("configs", w["config"], ".json"))
    mix = dict(load_json(_named("traffic", w["traffic"], ".json")),
               **(traffic or {}))

    def metrics(kind):
        return [(m, load_module(_named("metrics", m["name"], ".py"),
                                "metric"))
                for m in bench[kind]
                if "workloads" not in m or name in m["workloads"]]
    return SimpleNamespace(
        name=name, chips=int(w["chips"]), config=w["config"], cfg=cfg,
        traffic=mix,
        entry=load_module(_named("entries", mix["entry"], ".py"), "entry"),
        reference=load_module(_named("reference", w["config"], ".py"),
                              "reference"),
        limits=load_json(_named("limits", name, ".json")),
        end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))
